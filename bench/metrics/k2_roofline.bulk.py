"""k2_roofline.bulk: K2 `mega_kernel`'s least time over its device time
(%): least time = max(word operations / int32 peak, bytes / 3.35 TB/s),
with the served program's gates, words and records read at run time
(benchkit.roofline)."""
from benchkit.readers import k2_roofline


def read(run):
    return k2_roofline(run)
