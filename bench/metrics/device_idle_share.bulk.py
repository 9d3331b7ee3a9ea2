"""device_idle_share.bulk: the share of the traced part of the window
in which no kernel or copy ran on the device (%), from torch.profiler."""
from benchkit.readers import idle_share


def read(run):
    return idle_share(run)
