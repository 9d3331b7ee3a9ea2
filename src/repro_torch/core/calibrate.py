# Copied from src/repro/core/calibrate.py; the repro imports, PAD_UNIT and
# the measurement helpers' device argument (in place of interpret) differ.
"""Measurement-calibrated wall-clock cost model (DESIGN.md §12).

The eq. 22/23 model (core/cost_model.py) counts *cycles* and predicts
scheduled steps well (fig6 max error <6%), but the ``n_unit="auto"``
design-space search ultimately cares about what the fused
pack -> kernel -> unpack path costs *in seconds on the running backend*.
This module imports the SUMMA/WSE-2 performance-model discipline:

  1. decompose one execution into four phases —

         pack    H2D transfer + bit packing of the input batch
         setup   program-stream upload (addresses / opcodes / branches)
         kernel  the sub-kernel step loop itself
         unpack  result unpacking + D2H transfer

     each timed behind ``block_until_ready`` (kernels/logic_dsp/ops.py
     ``phased_infer_bits``; the numpy oracle records the same shape);

  2. map each phase to the cost-model regressors that drive it
     (:func:`phase_terms`) and fit ``seconds = coefs . regressors +
     offset`` per phase by least squares over a seeded grid of
     workloads x ``n_unit`` probes (:func:`fit_calibration`).  The
     kernel phase carries TWO regressors — the eq. 23 step count and
     the eq. 20 loop-cycles term — because measured step time has a
     fixed per-step overhead axis (loop trip count) and a slab-width
     axis (units x words) whose real ratio differs from the modelled
     fabric constants; one scale cannot fit both;

  3. expose the fitted model as :class:`WallClockModel`, a
     seconds-objective twin of :class:`~repro.core.cost_model.CostModel`
     that ``optimizer.binary_search(..., objective="wallclock")`` and
     ``CompileSpec(n_unit="auto", objective="wallclock")`` descend.

Degenerate calibration inputs (fewer than two probes, a zero-variance
phase regressor, gateless probe programs, non-finite measurements)
raise a typed :class:`CalibrationError` — never a silent NaN factor
propagated into the DSE; callers fall back to the cycles objective
explicitly.

Fitted :class:`Calibration` values round-trip through ``to_dict`` /
``from_dict`` and persist via ``ArtifactStore.save_calibration`` so warm
processes never re-fit (:func:`fit_count` is the counter the CLI smoke
pins, like the warm-start zero-compile pin).

This module imports numpy only; everything touching jax or the
scheduler is imported lazily inside the measurement helpers, so the
hot-path hook (``_ACTIVE`` below) costs one attribute read when
disabled.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.cost_model import (CostModel, FfclStats, normalize_layers,
                                   n_subkernels)

__all__ = [
    "PHASES", "CalibrationError", "PhaseTimer", "active_timer",
    "phase_terms", "PhaseProbe", "PhaseFit", "Calibration",
    "fit_calibration", "fit_count", "WallClockModel",
    "measure_program_phases", "default_probe_graphs", "default_probe_units",
    "collect_probes",
]

#: The phase decomposition, in execution order.
PHASES = ("pack", "setup", "kernel", "unpack")

#: Regressor names per phase (documentation of :func:`phase_terms`'s
#: tuple layout; the fit stores one coefficient per entry).
PHASE_REGRESSORS = {
    "pack": ("n_copy_mem_in",),
    "setup": ("n_read_addr_mem",),
    "kernel": ("n_subkernels", "n_step_width"),
    "unpack": ("n_outputs_drain",),
}

#: Schema version of the persisted calibration record.
FORMAT_VERSION = 1

#: The kernel layer pads each step's unit axis to this multiple with
#: NOP rows that still execute (``kernels.logic_dsp.ops.program_arrays``
#: sublane padding) — so the *executed* slab width at ``n_unit=u`` is
#: ``ceil(u / PAD_UNIT) * PAD_UNIT``, and the kernel phase's width
#: regressor must use the padded width or the fit systematically
#: under-predicts unaligned unit counts.
PAD_UNIT = 1  # the port's kernel pads no lanes (kernels/logic_dsp/ops.py)


class CalibrationError(RuntimeError):
    """A calibration could not be fitted, loaded, or applied.

    Raised on degenerate fit inputs (single probe, zero-variance phase
    regressor, gateless probe programs, non-finite measurements), on
    invalid serialized records, and on a ``wallclock`` objective with no
    calibration available.  Callers fall back to the ``cycles``
    objective — the typed error makes that fallback explicit, never a
    NaN factor silently steering the DSE."""


# ---------------------------------------------------------------------------
# phase-timing hook (the hot-path seam)
# ---------------------------------------------------------------------------

# The active timer, or None.  The instrumented runners
# (kernels/logic_dsp/ops.py, scheduler.execute_program_np) check this
# one module attribute per call — zero overhead when disabled.
_ACTIVE: "PhaseTimer | None" = None


class PhaseTimer:
    """Collects per-phase wall-clock samples from instrumented runners.

    Use as a context manager; while active, ``logic_infer_bits`` routes
    through the phased path and ``execute_program_np`` records its
    pack/setup/kernel/unpack split::

        with PhaseTimer() as t:
            logic_infer_bits(prog, bits)
        t.samples[0]["phases"]   # {"pack": s, "setup": s, ...}

    Timers nest (the previous active timer is restored on exit); each
    sample carries the phases dict plus free-form ``meta`` keys from the
    recording site (backend, n_unit, batch).
    """

    def __init__(self):
        self.samples: list[dict] = []
        self._prev: PhaseTimer | None = None

    def record(self, phases: dict, **meta) -> None:
        self.samples.append({"phases": dict(phases), "meta": dict(meta)})

    def __enter__(self) -> "PhaseTimer":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> bool:
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def active_timer() -> PhaseTimer | None:
    """The currently-installed :class:`PhaseTimer` (None when disabled)."""
    return _ACTIVE


# ---------------------------------------------------------------------------
# phase <-> cost-model regressor mapping
# ---------------------------------------------------------------------------

def phase_terms(model: CostModel, stats: FfclStats, n_unit: int,
                n_input_vectors: int) -> dict[str, tuple]:
    """The cost-model regressors (in cycles/steps) driving each phase.

    pack    <- eq. 18 input replication (``n_copy_mem_in``): linear in
               ``n_fanin * W``, independent of ``n_unit`` — like the
               measured H2D + packing time.
    setup   <- eq. 6/9 address-stream movement (``n_read_addr_mem``):
               linear in the program-stream footprint ``3 * n_unit *
               n_subkernels`` the setup phase uploads.
    kernel  <- (eq. 23 step count ``n_subkernels``, width work
               ``n_subkernels * n_unit``): the step count carries the
               real per-step fixed overhead (dispatch, loop control),
               the width term the units-x-words slab work.  The raw
               ``nsk * u`` product is used rather than eq. 20's
               ``n_loop_subkernels`` because the latter bakes in the
               fabric's 40-cycle per-step constant — far larger than
               the measured per-step overhead relative to the width
               slope, which would force a negative step-count
               coefficient in that basis.  Both raw-basis coefficients
               are physically non-negative, and ``nsk * u`` is strictly
               increasing within each ceil-staircase plateau, so the
               plateau-edge exact search stays valid.
    unpack  <- output drain (``n_outputs_drain``): linear in
               ``n_outputs * W``, like unpacking + D2H.

    The mapping deliberately avoids ``n_read_inputs_opcode_mem`` for the
    pack phase: its opcode-bytes component varies with ``n_unit`` while
    measured pack time does not, which would pollute the fit.
    """
    b = model.breakdown(stats, n_unit, n_input_vectors)
    nsk = float(n_subkernels(stats, n_unit))
    padded_u = -(-int(n_unit) // PAD_UNIT) * PAD_UNIT
    return {"pack": (b.n_copy_mem_in,),
            "setup": (b.n_read_addr_mem,),
            "kernel": (nsk, nsk * padded_u),
            "unpack": (b.n_outputs_drain,)}


# ---------------------------------------------------------------------------
# probes and fitting
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PhaseProbe:
    """One (workload, n_unit) measurement: modelled regressors vs
    seconds."""

    label: str
    n_unit: int
    n_input_vectors: int
    n_gates: int
    terms: dict            # phase -> regressor tuple (phase_terms)
    measured: dict         # phase -> seconds (min over reps)


@dataclass(frozen=True)
class PhaseFit:
    """``seconds = coefs . regressors + offset`` for one phase."""

    coefs: tuple           # one >= 0 coefficient per phase regressor
    offset: float          # fixed seconds per call (>= 0)
    n_probes: int
    median_abs_rel_err: float  # |pred - measured| / measured over probes

    def predict(self, terms) -> float:
        terms = tuple(terms)
        if len(terms) != len(self.coefs):
            raise CalibrationError(
                f"phase expects {len(self.coefs)} regressor(s), got "
                f"{len(terms)}: {terms!r}")
        return float(sum(c * float(t) for c, t in zip(self.coefs, terms))
                     + self.offset)


@dataclass(frozen=True)
class Calibration:
    """A complete fitted per-phase wall-clock calibration."""

    fits: dict = field(default_factory=dict)   # phase -> PhaseFit
    meta: dict = field(default_factory=dict)   # provenance (host, grid, ...)

    def __post_init__(self):
        missing = [p for p in PHASES if p not in self.fits]
        if missing:
            raise CalibrationError(
                f"calibration is missing phase fits for {missing}; "
                f"need all of {PHASES}")
        for p, f in self.fits.items():
            vals = (*f.coefs, f.offset)
            if not all(math.isfinite(v) and v >= 0.0 for v in vals):
                raise CalibrationError(
                    f"non-finite/negative factors for phase {p!r}: "
                    f"coefs={f.coefs!r} offset={f.offset!r}")

    def predict(self, terms: dict) -> dict:
        """Per-phase predicted seconds for one call, plus ``"total"``."""
        out = {p: self.fits[p].predict(terms[p]) for p in PHASES}
        out["total"] = sum(out[p] for p in PHASES)
        return out

    def seconds(self, terms: dict) -> float:
        total = sum(self.fits[p].predict(terms[p]) for p in PHASES)
        if not math.isfinite(total):
            raise CalibrationError(
                f"calibrated prediction is non-finite for terms {terms!r}")
        return total

    def median_abs_rel_err(self) -> float:
        """Worst phase's median |pred-measured|/measured from the fit."""
        return max(f.median_abs_rel_err for f in self.fits.values())

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "phases": {p: {"coefs": list(f.coefs), "offset": f.offset,
                           "n_probes": f.n_probes,
                           "median_abs_rel_err": f.median_abs_rel_err}
                       for p, f in self.fits.items()},
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        if not isinstance(d, dict):
            raise CalibrationError(
                f"calibration record must be a dict, got {type(d).__name__}")
        if d.get("format_version") != FORMAT_VERSION:
            raise CalibrationError(
                f"calibration format_version {d.get('format_version')!r} "
                f"!= {FORMAT_VERSION}; refit with this build")
        phases = d.get("phases")
        if not isinstance(phases, dict):
            raise CalibrationError("calibration record has no 'phases' map")
        try:
            fits = {p: PhaseFit(coefs=tuple(float(c) for c in f["coefs"]),
                                offset=float(f["offset"]),
                                n_probes=int(f["n_probes"]),
                                median_abs_rel_err=float(
                                    f["median_abs_rel_err"]))
                    for p, f in phases.items()}
        except (KeyError, TypeError, ValueError) as exc:
            raise CalibrationError(
                f"malformed calibration phase record: {exc!r}") from exc
        return cls(fits=fits, meta=dict(d.get("meta", {})))


_fits = 0


def fit_count() -> int:
    """Number of :func:`fit_calibration` runs in this process — the
    counter the warm-start CLI smoke pins to 0 for a store-loaded
    calibration (a fresh process must never silently re-fit)."""
    return _fits


def _nnls_fit(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with all coefficients clamped >= 0: solve
    unconstrained, then iteratively freeze negative coefficients at 0
    and re-solve the rest (columns of ``X`` include the intercept)."""
    active = list(range(X.shape[1]))
    coefs = np.zeros(X.shape[1])
    for _ in range(X.shape[1] + 1):
        if not active:
            break
        sol, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        if (sol >= 0).all():
            coefs[active] = sol
            break
        active = [a for a, s in zip(active, sol) if s >= 0]
    return coefs


def fit_calibration(probes: list[PhaseProbe],
                    meta: dict | None = None) -> Calibration:
    """Least-squares fit of per-phase coefficient/offset factors.

    Raises :class:`CalibrationError` on degenerate inputs — fewer than
    two probes, any gateless probe program (its kernel phase runs the
    reference fallback, a different backend), a zero-variance phase
    regressor (nothing to fit against), or non-finite measurements /
    regressors.  Coefficients and offsets are constrained ``>= 0`` so
    the model never predicts negative seconds.
    """
    global _fits
    if len(probes) < 2:
        raise CalibrationError(
            f"calibration needs >= 2 probes to fit coefs+offset, got "
            f"{len(probes)}; widen the workload x n_unit grid")
    gateless = [p.label for p in probes if p.n_gates <= 0]
    if gateless:
        raise CalibrationError(
            f"gateless probe program(s) {sorted(set(gateless))}: the "
            "kernel phase would measure the reference fallback, not the "
            "step loop; calibrate on graphs with gates")
    fits: dict[str, PhaseFit] = {}
    for phase in PHASES:
        arity = len(PHASE_REGRESSORS[phase])
        T = np.array([[float(v) for v in p.terms[phase]] for p in probes])
        y = np.array([float(p.measured[phase]) for p in probes])
        if T.shape != (len(probes), arity):
            raise CalibrationError(
                f"phase {phase!r} expects {arity} regressor(s) per probe, "
                f"got shape {T.shape}")
        if not (np.isfinite(T).all() and np.isfinite(y).all()):
            raise CalibrationError(
                f"non-finite regressor/measurement in phase {phase!r}: "
                f"terms={T.tolist()} measured={y.tolist()}")
        if (y < 0).any():
            raise CalibrationError(
                f"negative measured seconds in phase {phase!r}: {y.tolist()}")
        flat = [j for j in range(arity) if np.ptp(T[:, j]) == 0.0]
        if flat:
            names = [PHASE_REGRESSORS[phase][j] for j in flat]
            raise CalibrationError(
                f"zero-variance regressor(s) {names} for phase {phase!r}: "
                "the grid must vary the workload/n_unit axis this phase "
                "depends on")
        X = np.concatenate([T, np.ones((len(probes), 1))], axis=1)
        sol = _nnls_fit(X, y)
        coefs, offset = sol[:-1], float(sol[-1])
        pred = X @ sol
        if not np.isfinite(pred).all():
            raise CalibrationError(
                f"fit for phase {phase!r} produced non-finite predictions")
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(y > 0, np.abs(pred - y) / np.where(y > 0, y, 1.0),
                           np.abs(pred - y))
        fits[phase] = PhaseFit(coefs=tuple(float(c) for c in coefs),
                               offset=offset, n_probes=len(probes),
                               median_abs_rel_err=float(np.median(rel)))
    _fits += 1
    return Calibration(fits=fits, meta=dict(meta or {}))


# ---------------------------------------------------------------------------
# the seconds-objective model the DSE descends
# ---------------------------------------------------------------------------

class WallClockModel:
    """Seconds-objective twin of :class:`~repro.core.cost_model.CostModel`.

    ``optimizer.binary_search(..., objective="wallclock")`` calls
    :meth:`network_seconds`; :meth:`network_cycles` delegates to the
    wrapped cycles model, so one object can serve both objectives (the
    compiler records both picks in the DSE provenance).

    Unlike eq. 2's pipelined ``max(dm, comp)``, the measured fused path
    runs its phases *sequentially* (one process, one device queue), so a
    module costs the *sum* of its calibrated phases, and a layer's
    ``n_copies`` structurally-like modules cost ``n_copies`` times that.

    Every phase regressor is constant or increasing in ``n_unit`` on the
    intervals where the ceil-staircase step count is flat (same
    structure as the cycles model), so ``optimizer.binary_search``'s
    plateau-edge enumeration stays exact for this objective too.
    """

    def __init__(self, calibration: Calibration,
                 model: CostModel | None = None):
        if not isinstance(calibration, Calibration):
            raise CalibrationError(
                f"WallClockModel needs a Calibration, got "
                f"{type(calibration).__name__}")
        self.calibration = calibration
        self.model = model or CostModel()

    def module_seconds(self, stats: FfclStats, n_unit: int,
                       n_input_vectors: int) -> float:
        terms = phase_terms(self.model, stats, n_unit, n_input_vectors)
        return self.calibration.seconds(terms)

    def network_seconds(self, layers, n_unit: int,
                        parallel_factor: int = 1) -> float:
        tot = 0.0
        for lw in normalize_layers(layers):
            tot += lw.n_copies * self.module_seconds(
                lw.stats, n_unit, lw.n_input_vectors)
        return tot / parallel_factor

    def network_cycles(self, layers, n_unit: int,
                       parallel_factor: int = 1) -> float:
        return self.model.network_cycles(layers, n_unit, parallel_factor)


# ---------------------------------------------------------------------------
# measurement helpers (lazy jax / scheduler imports)
# ---------------------------------------------------------------------------

def measure_program_phases(prog, n_input_vectors: int, reps: int = 3,
                           seed: int = 0, *,
                           device=None) -> dict[str, float]:
    """Min-over-reps seconds per phase for one compiled program.

    Warms the phased runner first (trace + compile excluded), then takes
    the per-phase minimum over ``reps`` timed executions — the noise
    floor on a shared host, which is what the calibration should map the
    model regressors onto."""
    from repro_torch.kernels.logic_dsp.ops import phased_infer_bits
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(n_input_vectors, prog.n_inputs))
    bits = bits.astype(bool)
    phased_infer_bits(prog, bits, device=device)          # warm
    best = {p: math.inf for p in PHASES}
    for _ in range(max(1, reps)):
        _, phases = phased_infer_bits(prog, bits, device=device)
        for p in PHASES:
            best[p] = min(best[p], phases[p])
    return best


def default_probe_graphs(quick: bool = True, seed: int = 2024) -> dict:
    """The seeded calibration workload grid (shared by the benchmark
    harness, the CLI, and tests — same seed, same graphs)."""
    from repro_torch.core.gate_ir import random_graph
    rng = np.random.default_rng(seed)
    if quick:
        shapes = [(16, 300, 12, 64), (24, 900, 16, 96), (32, 1800, 24, 128)]
    else:
        shapes = [(16, 300, 12, 64), (24, 900, 16, 96), (32, 1800, 24, 128),
                  (48, 3600, 32, 192), (64, 7200, 48, 256)]
    return {f"g{n_gates}": random_graph(rng, n_inputs, n_gates, n_outputs,
                                        locality=loc)
            for n_inputs, n_gates, n_outputs, loc in shapes}


def default_probe_units(quick: bool = True) -> tuple[int, ...]:
    """The seeded ``n_unit`` probe axis matching
    :func:`default_probe_graphs`.  Five points even in quick mode: with
    three the per-step vs slab-width split of the kernel fit is barely
    conditioned and the resulting picks drift outside the DSE gate."""
    return (8, 16, 32, 64, 128) if quick else (8, 16, 32, 64, 128, 256)


def collect_probes(graphs: dict, n_units, n_input_vectors: int = 1024,
                   model: CostModel | None = None, reps: int = 3,
                   *, device=None) -> list[PhaseProbe]:
    """Compile and measure every (workload, n_unit) grid point.

    Probes compile with ``optimize="none"`` (the grid graphs are the
    workload — the fit must see exactly the closed-form stats the DSE
    will probe) and use ``FfclStats.from_graph`` regressors, the same
    eq. 23 path ``WallClockModel`` predicts with.

    All grid points are measured INTERLEAVED: every program is compiled
    and trace-warmed up front, then ``reps`` round-robin passes take one
    timed execution per point each, keeping the per-phase minimum.
    Measuring points sequentially (all reps of one point, then the next)
    lets slow host drift over the collection window masquerade as
    ``n_unit`` dependence and visibly destabilizes the fitted
    coefficients run-to-run.
    """
    from repro_torch.core.scheduler import compile_graph
    from repro_torch.core.spec import CompileSpec
    from repro_torch.kernels.logic_dsp.ops import phased_infer_bits
    model = model or CostModel()
    rng = np.random.default_rng(0)
    grid = []
    for label, g in graphs.items():
        stats = FfclStats.from_graph(g)
        bits = rng.integers(0, 2, (n_input_vectors, g.n_inputs))
        bits = bits.astype(bool)
        for u in n_units:
            prog = compile_graph(g, CompileSpec(n_unit=int(u),
                                                optimize="none"))
            phased_infer_bits(prog, bits, device=device)    # warm
            grid.append((label, g, stats, int(u), prog, bits,
                         {p: math.inf for p in PHASES}))
    for _ in range(max(1, reps)):
        for _, _, _, _, prog, bits, best in grid:
            _, phases = phased_infer_bits(prog, bits, device=device)
            for p in PHASES:
                best[p] = min(best[p], phases[p])
    return [PhaseProbe(label=label, n_unit=u,
                       n_input_vectors=n_input_vectors, n_gates=g.n_gates,
                       terms=phase_terms(model, stats, u, n_input_vectors),
                       measured=dict(best))
            for label, g, stats, u, _, _, best in grid]
