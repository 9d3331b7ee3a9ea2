"""k2_ms.conv8: K2 `mega_kernel`'s device time a launch (ms) over the
trace, one launch a wave (benchkit.readers.kernel_launches)."""
from benchkit.readers import kernel_launches


def read(run):
    n, seconds = kernel_launches(run)
    return seconds / n * 1e3 if n else None
