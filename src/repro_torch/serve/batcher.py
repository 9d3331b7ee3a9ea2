# Copied from src/repro/serve/batcher.py: Request, RequestBatcher (the token
# decode batcher of the LM serving loop) and SlotTable (the logic engine's).
"""Request batching for the serving path (paper §5.2.4 host-side queueing).

The paper enqueues multiple OpenCL kernels out-of-order to keep the fabric
busy; here a ``RequestBatcher`` packs incoming prompts into fixed-shape
decode batches (continuous batching, slot-based): finished slots are
recycled without recompiling, because the decode step is shape-stable.

``SlotTable`` generalizes the same slot discipline beyond token decode: it
allocates *sample rows* of a fixed-capacity batch (for the logic engine,
``32 * W`` rows — the sample capacity of a packed ``(n_wires, W)`` word
slab, see core/packing.py). A bit-vector request occupies ``len(samples)``
rows for one fabric invocation and the rows are recycled for the next
admission wave, so ragged request sizes (not multiples of 32) share words
with their neighbours instead of padding to private word boundaries.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    generated: list = field(default_factory=list)
    done: bool = False


class RequestBatcher:
    """Slot-based continuous batcher over a fixed decode batch size."""

    def __init__(self, batch_size: int, eos_id: int = -1):
        self.batch_size = batch_size
        self.eos_id = eos_id
        self.slots: list[Request | None] = [None] * batch_size
        self.queue: list[Request] = []
        self.finished: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self) -> list[tuple[int, Request]]:
        """Fill empty slots from the queue; returns newly admitted."""
        admitted = []
        for i in range(self.batch_size):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                admitted.append((i, req))
        return admitted

    def active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots], dtype=bool)

    def record_tokens(self, tokens: np.ndarray) -> None:
        """tokens: (batch,) next token per slot; retire finished slots."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(tokens[i])
            req.generated.append(tok)
            if (tok == self.eos_id or
                    len(req.generated) >= req.max_new_tokens):
                req.done = True
                self.finished.append(req)
                self.slots[i] = None

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)


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
