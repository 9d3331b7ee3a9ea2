# Copied from src/repro/core/levelize.py; only the repro imports differ.
"""Levelization (paper §6.1, eq. 1): l_i = 1 + max_{j in fanin(i)} l_j.

Gates at the same logic level have no connections to each other, so their
operations can execute simultaneously on the compute units. Levelization is
the scheduling skeleton: each level becomes >=1 sub-kernels (scheduler.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.gate_ir import LogicGraph


@dataclass(frozen=True)
class Levelization:
    """Per-wire logic levels plus per-level gate lists."""

    levels: np.ndarray          # (n_wires,) int64; consts/inputs are level 0
    depth: int                  # max level over all gates (0 if no gates)
    level_gates: list[np.ndarray]  # level l (1-based) -> gate indices at l

    def gates_at(self, level: int) -> np.ndarray:
        """Gate indices (into graph.gates) at logic level ``level`` (>=1)."""
        return self.level_gates[level - 1]

    def histogram(self) -> np.ndarray:
        """Number of gates per level, shape (depth,)."""
        return np.array([len(g) for g in self.level_gates], dtype=np.int64)


def levelize(graph: LogicGraph) -> Levelization:
    """Single topological pass (graph.gates is already in topo order).

    The level recurrence is inherently sequential, so it runs over plain
    Python ints (no per-gate numpy scalar overhead); the per-level buckets
    are then built with one vectorized sort.
    """
    base = graph.first_gate_wire
    lv: list[int] = [0] * graph.n_wires
    for i, (op, a, b) in enumerate(graph.gates):
        la, lb = lv[a], lv[b]
        lv[base + i] = (la if la >= lb else lb) + 1
    levels = np.asarray(lv, dtype=np.int64)
    depth = int(levels[base:].max()) if graph.n_gates else 0
    gate_levels = levels[base:]
    by_level = np.argsort(gate_levels, kind="stable")
    bounds = np.searchsorted(gate_levels[by_level],
                             np.arange(1, depth + 2))
    level_gates = [by_level[bounds[lev]:bounds[lev + 1]]
                   for lev in range(depth)]
    return Levelization(levels=levels, depth=depth, level_gates=level_gates)
