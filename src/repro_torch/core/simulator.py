# Copied from src/repro/core/simulator.py; only the repro imports differ.
"""Discrete-event simulation of the double-buffered FFCL pipeline.

Plays the role of the paper's "actual hardware implementation" in the Fig. 6
model-validation study (no FPGA/TPU timing exists in this container). The
simulator is strictly finer-grained than the analytical model:

  * per-step (sub-kernel) compute events with *actual* unit occupancy
    (the model's stated pessimism: it assumes every step uses all units);
  * two on-chip buffers; data movement of module k+1 may only start once
    buffer (k+1) mod 2 was released by compute of module k-1 (double
    buffering, paper §5.2.2);
  * one DMA engine and one compute engine (task pipelining, §5.2.3).

The simulator consumes real compiled :class:`LogicProgram` objects, so its
occupancy profile is exact, not statistical.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.cost_model import CostModel, FfclStats
from repro_torch.core.scheduler import LogicProgram


@dataclass
class SimResult:
    total_cycles: float
    dm_cycles: list[float]        # per-module data-movement duration
    compute_cycles: list[float]   # per-module compute duration
    dm_busy: float                # total DMA-engine busy cycles
    compute_busy: float
    timeline: list[tuple[str, int, float, float]]  # (stage, module, t0, t1)

    @property
    def bound(self) -> str:
        return "data_moves" if self.dm_busy >= self.compute_busy else "compute"


def _module_durations(model: CostModel, prog: LogicProgram,
                      n_input_vectors: int) -> tuple[float, float]:
    """(data-movement cycles, compute cycles) for one module, exact occupancy.

    The stats come from the compiled program, so both the stream-movement
    terms (which scale with the *scheduled*, possibly level-fused, step
    count) and the compute loop (per-step non-NOP occupancy) are exact.
    """
    stats = FfclStats.from_program(prog)
    dm = model.n_data_moves(stats, prog.n_unit, n_input_vectors)
    comp = model.n_compute(stats, prog.n_unit, n_input_vectors,
                           exact_occupancy=True)
    return dm, comp


def simulate_pipeline(programs: list[LogicProgram], n_input_vectors: int,
                      model: CostModel | None = None,
                      n_buffers: int = 2) -> SimResult:
    """Simulate executing ``programs`` back-to-back with task pipelining."""
    model = model or CostModel()
    m = len(programs)
    dms, comps = [], []
    for p in programs:
        dm, comp = _module_durations(model, p, n_input_vectors)
        dms.append(dm)
        comps.append(comp)

    dm_end = [0.0] * m
    comp_end = [0.0] * m
    timeline: list[tuple[str, int, float, float]] = []
    for k in range(m):
        # DMA engine free after previous transfer; buffer (k mod n_buffers)
        # free after compute of module k - n_buffers finished.
        dma_free = dm_end[k - 1] if k else 0.0
        buf_free = comp_end[k - n_buffers] if k >= n_buffers else 0.0
        t0 = max(dma_free, buf_free)
        dm_end[k] = t0 + dms[k]
        timeline.append(("dm", k, t0, dm_end[k]))
        c0 = max(dm_end[k], comp_end[k - 1] if k else 0.0)
        comp_end[k] = c0 + comps[k]
        timeline.append(("compute", k, c0, comp_end[k]))
    return SimResult(
        total_cycles=comp_end[-1] if m else 0.0,
        dm_cycles=dms, compute_cycles=comps,
        dm_busy=float(sum(dms)), compute_busy=float(sum(comps)),
        timeline=timeline)


def simulate_no_pipeline(programs: list[LogicProgram], n_input_vectors: int,
                         model: CostModel | None = None) -> SimResult:
    """Paper Fig. 8(a): sequential data-move -> compute per module."""
    model = model or CostModel()
    t = 0.0
    dms, comps, timeline = [], [], []
    for k, p in enumerate(programs):
        dm, comp = _module_durations(model, p, n_input_vectors)
        timeline.append(("dm", k, t, t + dm))
        t += dm
        timeline.append(("compute", k, t, t + comp))
        t += comp
        dms.append(dm)
        comps.append(comp)
    return SimResult(total_cycles=t, dm_cycles=dms, compute_cycles=comps,
                     dm_busy=float(sum(dms)), compute_busy=float(sum(comps)),
                     timeline=timeline)
