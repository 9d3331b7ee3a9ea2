# SlotTable copied verbatim from src/repro/serve/batcher.py; the rest of that
# module (the token-decode RequestBatcher) is not part of this package.
"""Request batching for the serving path (paper §5.2.4 host-side queueing).

``SlotTable`` allocates *sample rows* of a fixed-capacity batch (for the
logic engine, ``32 * W`` rows — the sample capacity of a packed
``(n_wires, W)`` word slab, see core/packing.py). A bit-vector request
occupies ``len(samples)`` rows for one fabric invocation and the rows are
recycled for the next admission wave, so ragged request sizes (not
multiples of 32) share words with their neighbours instead of padding to
private word boundaries.
"""
from __future__ import annotations

import numpy as np


class SlotTable:
    """Row-granular slot allocator over a fixed sample capacity.

    ``acquire(n)`` hands out ``n`` free row indices (lowest-first, so the
    active region stays dense and word-aligned requests pack adjacently);
    ``release(rows)`` recycles them. The high-water mark records the densest
    simultaneous occupancy ever reached — the serving analogue of decode
    batch utilization.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._free: list[int] = list(range(capacity - 1, -1, -1))  # stack
        self._allocated: set[int] = set()
        self.high_water = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.capacity - len(self._free)

    def acquire(self, n: int) -> np.ndarray | None:
        """Reserve ``n`` rows; None when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            return None
        # bulk slice off the top of the stack (reversed = pop order, so
        # the handed-out rows stay lowest-first) — a per-row pop loop is
        # measurable serving overhead at capacity-sized waves
        taken = self._free[len(self._free) - n:]
        del self._free[len(self._free) - n:]
        taken.reverse()
        self._allocated.update(taken)
        self.high_water = max(self.high_water, self.n_active)
        return np.array(taken, dtype=np.int64)

    def release(self, rows: np.ndarray) -> None:
        lst = np.asarray(rows, dtype=np.int64).tolist()
        held = set(lst)
        if lst and not (0 <= min(lst) and max(lst) < self.capacity):
            bad = next(r for r in lst if not 0 <= r < self.capacity)
            raise ValueError(f"row {bad} out of range")
        if len(held) != len(lst):
            bad = next(r for r in lst if lst.count(r) > 1)
            raise RuntimeError(f"row {bad} released without being held")
        if not held <= self._allocated:
            bad = next(r for r in lst if r not in self._allocated)
            raise RuntimeError(f"row {bad} released without being held")
        self._allocated -= held
        self._free.extend(reversed(lst))
