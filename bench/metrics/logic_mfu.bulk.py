"""logic_mfu.bulk: the gate word operations the window's served samples
needed (gates x samples / 32) over the window's seconds at the card's
int32 peak (%): the whole wave's share of the chip."""
from benchkit.readers import logic_mfu


def read(run):
    return logic_mfu(run)
