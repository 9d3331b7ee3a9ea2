"""copy_ms.bulk: device time of the host-to-device and device-to-host
copies per wave (ms), from torch.profiler over the traced part of the
window (waves counted as K2 launches in it)."""
from benchkit.readers import copy_ms


def read(run):
    return copy_ms(run)
