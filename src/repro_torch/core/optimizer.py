# Copied from src/repro/core/optimizer.py; only the repro imports differ.
"""Design-space exploration over the number of compute units (paper §7.2).

Latency vs n_unit is U-shaped (paper Fig. 6): more units shrink the compute
term (fewer sub-kernel steps) but grow the address-stream data-movement term
(3 addresses per unit per step, and padding waste).  Eq. 26 minimizes total
cost subject to n_unit <= N_max; the paper does it by binary search on the
discrete derivative, which assumes the curve is unimodal.  It is NOT: the
step count sum_l ceil(gates_l / n_unit) is a staircase, so the total cost
is a descending sawtooth crossing an ascending line — full of local minima
(the committed BENCH snapshot caught the descent picking n_unit=20 at
150.7us modelled where the sweep best was n_unit=32 at 133.2us).

:func:`binary_search` is therefore *exact* now: within any interval of
``n_unit`` where every layer's per-level ``ceil(hist_l / n_unit)`` plateau
holds, every cost term is constant or strictly increasing in ``n_unit``
(address stream ~ 3*u*nsk, per-step gather/execute/scatter ~ u; the
calibrated wall-clock phases inherit the same structure from
:func:`~repro.core.calibrate.phase_terms`), so the global minimum always
lands on a plateau *left edge* ``u = ceil(h / k)``.  Enumerating those
edges — O(sum_l sqrt(gates_l)) probes, not the full range — and taking the
argmin reproduces the exhaustive sweep's pick exactly, ties included
(both resolve to the smallest minimizing ``n_unit``).

Both searches take ``objective="cycles"`` (default: the paper's modelled
cycles via ``model.network_cycles``) or ``objective="wallclock"`` (the
measurement-calibrated seconds of
:class:`~repro.core.calibrate.WallClockModel.network_seconds`; see
DESIGN.md §12).  Network loads are
:class:`~repro.core.cost_model.LayerLoad` values (legacy
``(stats, n_copies, n_input_vectors)`` tuples still accepted).  With the
:class:`~repro.core.spec.CompileSpec` API this search is no longer a
separate manual workflow: ``CompileSpec(n_unit="auto")`` routes every
compile path through :func:`binary_search` via
:class:`~repro.core.compiler.LogicCompiler`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.cost_model import (FfclStats, LayerLoad, normalize_layers)

__all__ = ["FfclStats", "LayerLoad", "SearchResult", "sweep",
           "binary_search", "OBJECTIVES"]

#: Valid DSE objectives: modelled cycles (paper §7.2) or calibrated
#: wall-clock seconds (DESIGN.md §12).
OBJECTIVES = ("cycles", "wallclock")


@dataclass
class SearchResult:
    best_n_unit: int
    #: Best objective value: modelled cycles for ``objective="cycles"``,
    #: calibrated seconds for ``objective="wallclock"`` (the field name
    #: predates the objective knob and is kept for API stability).
    best_cycles: float
    evaluations: list[tuple[int, float]]   # (n_unit, cost) probes, in order
    objective: str = "cycles"
    #: The other objective's pick, when the caller resolved both
    #: (LogicCompiler records cycles+wallclock picks side by side in the
    #: DSE provenance).  ``compare=False``: provenance, not identity.
    alt: "SearchResult | None" = field(default=None, compare=False)


def _network_cost(model, layers: list[LayerLoad], n_unit: int,
                  parallel_factor: int = 1,
                  objective: str = "cycles") -> float:
    if objective == "wallclock":
        fn = getattr(model, "network_seconds", None)
        if fn is None:
            raise TypeError(
                "objective='wallclock' needs a model exposing "
                "network_seconds (core.calibrate.WallClockModel, built "
                f"from a fitted Calibration); got {type(model).__name__} "
                "— fit/load a calibration or use objective='cycles'")
        return fn(layers, n_unit, parallel_factor)
    return model.network_cycles(layers, n_unit, parallel_factor)


def _check_objective(objective: str) -> None:
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; use one of {OBJECTIVES}")


def sweep(model, layers, n_units: list[int], parallel_factor: int = 1,
          objective: str = "cycles") -> SearchResult:
    """Exhaustive probe of every candidate unit count (for plots)."""
    _check_objective(objective)
    layers = normalize_layers(layers)
    if not n_units:
        raise ValueError("sweep needs at least one n_unit candidate")
    if min(n_units) < 1:
        raise ValueError(f"n_unit candidates must be >= 1, got {n_units!r}")
    evals = [(u, _network_cost(model, layers, u, parallel_factor, objective))
             for u in n_units]
    best = min(evals, key=lambda t: t[1])
    return SearchResult(best[0], best[1], evals, objective=objective)


def _plateau_edges(h: int, lo: int, hi: int, out: set) -> None:
    """Add to ``out`` every u in (lo, hi] where ``ceil(h / u)`` steps down
    — the left edge of the k-step plateau is ``u = ceil(h / k)``; the
    distinct edges are enumerated in O(sqrt(h)) by jumping k to the next
    value that shrinks the edge."""
    k = 1
    while True:
        u = -(-h // k)                       # ceil(h / k)
        if u <= lo:
            break
        if u <= hi:
            out.add(u)
        if u == 1:
            break
        k = -(-h // (u - 1))                 # smallest k with ceil(h/k) < u


def _candidates(layers: list[LayerLoad], lo: int, hi: int) -> list[int]:
    """Every n_unit in [lo, hi] that can be a global minimum: the range
    bounds plus each layer's per-level plateau left edges."""
    cands = {lo, hi}
    for lw in layers:
        hist = np.asarray(lw.stats.level_histogram).ravel()
        for h in hist.tolist():
            if h and h > 0:
                _plateau_edges(int(h), lo, hi, cands)
    return sorted(cands)


def binary_search(model, layers, n_unit_max: int, parallel_factor: int = 1,
                  n_unit_min: int = 1,
                  objective: str = "cycles") -> SearchResult:
    """Exact minimization over ``n_unit in [n_unit_min, n_unit_max]``.

    Supersedes the paper's §8.1 descent on the discrete derivative,
    which assumed a unimodal curve: the ceil-staircase step count makes
    the cost a sawtooth with local minima, and the descent demonstrably
    parked in them (see the module docstring).  Instead, every candidate
    that can host the global minimum — the plateau left edges of each
    layer's ``ceil(hist_l / n_unit)`` plus the range bounds — is probed
    once, and the smallest minimizing unit count wins, which is exactly
    the exhaustive sweep's pick (ties included).  Probe count stays
    O(sum over levels of sqrt(gates)) — logarithmic-in-spirit, far below
    the full range — and every probe lands in
    ``[n_unit_min, n_unit_max]`` exactly once in ``evaluations``.
    """
    _check_objective(objective)
    layers = normalize_layers(layers)
    if n_unit_min < 1:
        raise ValueError(f"n_unit_min must be >= 1, got {n_unit_min}")
    if n_unit_max < n_unit_min:
        raise ValueError(
            f"empty search range: n_unit_max={n_unit_max} < "
            f"n_unit_min={n_unit_min}")
    evals: list[tuple[int, float]] = []
    best_u, best_c = None, None
    for u in _candidates(layers, n_unit_min, n_unit_max):
        c = _network_cost(model, layers, u, parallel_factor, objective)
        evals.append((u, c))
        if best_c is None or c < best_c:
            best_u, best_c = u, c
    return SearchResult(best_u, best_c, evals, objective=objective)
