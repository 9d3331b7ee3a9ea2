"""Whether what the timed path served is correct: a plain comparison.

Every checked request's served bits are compared with the reference's
bits for the same samples (``reference.binarized.pattern_table``, indexed
by the pattern each payload row holds).  The run is correct when no bit
differs, every request due in the window was answered, and at least one
request was checked.  The numbers compared and their limits go into the
result line's last key and the last lines of standard error.
"""
from __future__ import annotations

import numpy as np

from reference.binarized import pattern_table


def compare(checks, layers, pool_idx: np.ndarray) -> dict:
    """``checks``: ``(pool offset, n, served bits)`` a checked request."""
    table = pattern_table(layers)
    wrong = rows = 0
    for off, n, out in checks:
        want = table[pool_idx[off:off + n]]
        out = np.asarray(out)
        rows += n
        wrong += int((out != want).sum()) if out.shape == want.shape \
            else want.size
    return {"bits_wrong": wrong, "rows_checked": rows,
            "requests_checked": len(checks)}


def limits(compared: dict, unanswered: int) -> dict:
    """The numbers compared, each with its limit (``max`` or ``min``)."""
    return {"bits_wrong": {"value": compared["bits_wrong"], "max": 0},
            "requests_unanswered": {"value": unanswered, "max": 0},
            "requests_checked": {"value": compared["requests_checked"],
                                 "min": 1}}


def holds(checks: dict) -> bool:
    return all((c["value"] <= c["max"]) if "max" in c else
               (c["value"] >= c["min"]) for c in checks.values())
