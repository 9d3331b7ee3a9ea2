# Copied from src/repro/core/spec.py; only the repro imports differ.
"""One declarative compilation target: :class:`CompileSpec` (DESIGN.md §8).

The paper's framework is a *compiler*: one flow maps FFCL blocks onto a
parameterized DSP fabric (n_unit; §5.2 partition/pipeline; §7.2
design-space search). PRs 1-4 grew that parameterization as six loose
kwargs (``n_unit``, ``alloc``, ``opcode_sort``, ``fuse_levels``,
``optimize``, ``max_gates``) re-threaded ad hoc through every compile
path, with inconsistent defaults (scheduler ``alloc="direct"`` vs cache
``"liveness"``) and a hand-rolled cache-key tuple kept in sync by hand.

This module is the consolidation point:

  * :class:`CompileSpec` — a frozen, validated dataclass capturing the
    full compilation target.  Every compile-path entry point
    (``scheduler.compile_graph``, ``partition``/``compile_partitions``,
    ``serve.ProgramCache.get``, ``serve.LogicEngine``,
    ``flow.build_classifier``/``FlowConfig``, ``models.logic_mlp
    .ffn_to_program``) accepts one; new fabric knobs land HERE and
    nowhere else.
  * the **canonical defaults** — one source of truth (``alloc=
    "liveness"``, ``optimize="default"``); consumers stop declaring
    their own.  :meth:`CompileSpec.paper_exact` is the pinned
    paper-faithful preset (``fuse_levels=False, optimize="none",
    alloc="direct", opcode_sort=False`` — eq. 23 layout, raw factoring,
    address == wire id).
  * :meth:`CompileSpec.cache_key` — THE cache-keying code path
    (replaces ``ProgramCache``'s hand-built tuple and subsumes
    ``PassManager.cache_key`` for the optimized-graph memo).
  * :meth:`CompileSpec.to_dict` / :meth:`CompileSpec.from_dict` — JSON
    round-trip so benchmarks and reports record the exact target they
    measured (``BENCH_logic.json`` rows carry it).
  * :func:`resolve_spec` — the one deprecation shim every entry point
    routes its legacy kwargs through (``DeprecationWarning`` whose
    message starts with :data:`DEPRECATION_PREFIX`, so CI can run the
    suite with ``-W "error:legacy compile kwargs"`` and prove internals
    are fully migrated).

``n_unit="auto"`` makes the paper's §7.2 design-space search a spec
*value*: the :class:`~repro.core.compiler.LogicCompiler` facade (and the
serving registry on top of it) resolves it per graph through
``optimizer.binary_search`` before compiling or cache-keying.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

from repro_torch.core.opt import PassManager, resolve_pipeline

# Every shim warning message starts with this prefix, so a warnings
# filter can turn exactly these into errors (the CI "internals are fully
# migrated" job) without tripping on third-party DeprecationWarnings:
#   python -m pytest -W "error:legacy compile kwargs"
DEPRECATION_PREFIX = "legacy compile kwargs"

_ALLOCS = ("direct", "liveness")

# sentinel distinguishing "kwarg not passed" from an explicit None
# (optimize=None legally meant "no optimization" in the old API)
_UNSET = object()


@dataclass(frozen=True)
class CompileSpec:
    """The full compilation target, as one declarative value.

    Fields (validated in ``__post_init__``):

    n_unit:
        Compute units of the fabric (int >= 1), or ``"auto"`` to let the
        compile path pick the Pareto point via ``optimizer.binary_search``
        on the graph's closed-form eq. 23 stats (paper §7.2).  ``"auto"``
        is resolved to a concrete int before anything is compiled or
        cache-keyed (:meth:`cache_key` refuses an unresolved spec).
    alloc:
        Address allocation: ``"liveness"`` (canonical default;
        register-allocation-style reuse) or ``"direct"`` (paper §6.3,
        address == wire id).
    opcode_sort / fuse_levels:
        Scheduler layout knobs (core/scheduler.py §1.2/§1.3).  Both
        default on; :meth:`paper_exact` turns both off.
    optimize:
        Gate-level pass pipeline (core/opt.py): ``"default"`` /
        ``"none"`` / a :class:`PassManager`.  Normalized at construction
        — the stored value is always a resolved ``PassManager`` or the
        string ``"none"`` — so ``CompileSpec(optimize="default") ==
        CompileSpec(optimize=PassManager.default())``.
    max_gates:
        Partition budget (int >= 1) or ``None`` (monolithic).  Budget-
        aware entry points (``LogicCompiler``, ``ProgramCache``,
        ``partition``) split graphs above it; the monolithic primitive
        ``compile_graph`` documents that it ignores it.
    objective:
        What ``n_unit="auto"`` minimizes: ``"cycles"`` (default — the
        paper's modelled eq. 22 cycles) or ``"wallclock"`` (the
        measurement-calibrated per-phase seconds model of
        core/calibrate.py; needs a ``LogicCompiler`` carrying a fitted
        ``Calibration``, else resolution raises ``CalibrationError``).
        Irrelevant once ``n_unit`` is concrete: the knob steers the
        search, not the emitted program, so it is NOT part of
        :meth:`cache_key` and serializes only when non-default
        (``objective="cycles"`` specs round-trip byte-identically to
        pre-knob records).
    """

    n_unit: object = 64                  # int >= 1 | "auto"
    alloc: str = "liveness"
    opcode_sort: bool = True
    fuse_levels: bool = True
    optimize: object = "default"         # normalized: PassManager | "none"
    max_gates: int | None = None
    objective: str = "cycles"            # "cycles" | "wallclock"
    #: Static schedule verification (core/verify.py, DESIGN.md §13):
    #: ``"off"`` (default), ``"compile"`` (prove every freshly compiled
    #: artifact), ``"load"`` (re-prove store-loaded / alias-resolved
    #: artifacts before serving — the §10.4 alias-trust closure), or
    #: ``"full"`` (both; the CI setting).  Purely *operational*: it
    #: never changes the emitted streams, so it is excluded from
    #: :meth:`cache_key`, from equality/hashing (``compare=False``),
    #: and from :meth:`to_dict` — store keys, alias records, and BENCH
    #: rows stay byte-identical across verify-on and verify-off fleets
    #: (``from_dict`` still accepts the key for CLI convenience).
    verify: str = dataclasses.field(default="off", compare=False)

    def __post_init__(self):
        n = self.n_unit
        if n != "auto" and not (isinstance(n, int)
                                and not isinstance(n, bool) and n >= 1):
            raise ValueError(
                f"n_unit must be an int >= 1 or 'auto', got {n!r}")
        if self.alloc not in _ALLOCS:
            raise ValueError(
                f"unknown alloc strategy {self.alloc!r}; use one of {_ALLOCS}")
        for knob in ("opcode_sort", "fuse_levels"):
            if not isinstance(getattr(self, knob), bool):
                raise ValueError(f"{knob} must be a bool, "
                                 f"got {getattr(self, knob)!r}")
        if self.max_gates is not None and not (
                isinstance(self.max_gates, int)
                and not isinstance(self.max_gates, bool)
                and self.max_gates >= 1):
            raise ValueError(
                f"max_gates must be an int >= 1 or None, "
                f"got {self.max_gates!r}")
        if self.objective not in ("cycles", "wallclock"):
            raise ValueError(
                f"unknown objective {self.objective!r}; "
                "use 'cycles' or 'wallclock'")
        if self.verify not in ("off", "compile", "load", "full"):
            raise ValueError(
                f"unknown verify mode {self.verify!r}; use "
                "'off', 'compile', 'load', or 'full'")
        # normalize the optimize knob once, at the boundary: equal targets
        # compare equal however they were spelled, and `.pipeline` below
        # never re-resolves.
        pipeline = resolve_pipeline(self.optimize)
        object.__setattr__(self, "optimize",
                           "none" if pipeline is None else pipeline)

    # -- presets ------------------------------------------------------------

    @classmethod
    def paper_exact(cls, n_unit: object = 64, *,
                    max_gates: int | None = None) -> "CompileSpec":
        """The paper-faithful target: eq. 23 step layout (no level
        fusion, no opcode sorting), raw synthesis output (no pass
        pipeline), and the §6.3 direct address map (buffer row == wire
        id).  Pinned by tests/test_spec.py — changing any of these
        breaks the paper-exact reproduction contract."""
        return cls(n_unit=n_unit, alloc="direct", opcode_sort=False,
                   fuse_levels=False, optimize="none", max_gates=max_gates)

    # -- derived views ------------------------------------------------------

    @property
    def pipeline(self) -> PassManager | None:
        """The resolved pass pipeline (``None`` when ``optimize="none"``)."""
        return None if self.optimize == "none" else self.optimize

    @property
    def optimize_key(self) -> tuple:
        """Canonical identity of the optimization stage — what the
        serving registry's optimized-graph memo keys on (subsumes the
        bare ``PassManager.cache_key`` it used before)."""
        return ("none",) if self.pipeline is None else self.pipeline.cache_key

    @property
    def resolved(self) -> bool:
        """True iff ``n_unit`` is concrete (not ``"auto"``)."""
        return self.n_unit != "auto"

    # -- functional updates -------------------------------------------------

    def with_(self, **changes) -> "CompileSpec":
        """Functional update: a new validated spec with ``changes``
        applied (the original is immutable and unaffected)."""
        unknown = set(changes) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise TypeError(f"unknown CompileSpec field(s): {sorted(unknown)}")
        return dataclasses.replace(self, **changes)

    def normalize(self, graph) -> "CompileSpec":
        """The canonical spec for compiling ``graph``: a partition budget
        the graph already fits under compiles the identical monolithic
        program as no budget at all, so it normalizes to ``None`` —
        engines with different (unbinding) budgets share one cache
        entry (DESIGN.md §5.1)."""
        if self.max_gates is not None and graph.n_gates <= self.max_gates:
            return self.with_(max_gates=None)
        return self

    # -- cache keying -------------------------------------------------------

    def cache_key(self) -> tuple:
        """THE canonical cache key of this compilation target.

        Replaces the hand-built ``(n_unit, alloc, max_gates)`` tuple of
        ``serve.ProgramCache`` (which silently missed ``opcode_sort`` /
        ``fuse_levels``) — every field that changes the emitted streams
        is in here, and equivalent constructions (``optimize="default"``
        vs an explicit default ``PassManager``) key identically.  Pair
        it with a graph fingerprint for a full registry key
        (``ProgramCache.key_of``).  Refuses an unresolved ``"auto"``
        spec: resolve ``n_unit`` first (``LogicCompiler.resolve``) so a
        key always names one concrete program.
        """
        if not self.resolved:
            raise ValueError(
                "cache_key() requires a concrete n_unit; resolve "
                "n_unit='auto' first (LogicCompiler.resolve / "
                "ProgramCache.get do this per graph)")
        return (self.n_unit, self.alloc, self.opcode_sort, self.fuse_levels,
                self.optimize_key, self.max_gates)

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-serializable form (exact inverse of :meth:`from_dict`).

        ``optimize`` serializes as ``"none"`` or ``"default"``; a custom
        :class:`PassManager` has no declarative serial form, so it
        raises — benchmarks/reports that record specs stick to the named
        pipelines.  ``objective`` is emitted only when non-default, so
        every ``"cycles"`` spec (all pre-knob records, BENCH rows, and
        store aliases) keeps its exact historical serial form.
        """
        if self.pipeline is None:
            opt = "none"
        elif self.pipeline.cache_key == PassManager.default().cache_key:
            opt = "default"
        else:
            raise ValueError(
                f"custom pass pipeline {self.pipeline!r} is not "
                "JSON-serializable; only 'none'/'default' round-trip")
        d = {"n_unit": self.n_unit, "alloc": self.alloc,
             "opcode_sort": self.opcode_sort,
             "fuse_levels": self.fuse_levels,
             "optimize": opt, "max_gates": self.max_gates}
        if self.objective != "cycles":
            d["objective"] = self.objective
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompileSpec":
        """Rebuild a spec from :meth:`to_dict` output (missing keys take
        the canonical defaults; unknown keys are an error)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"unknown CompileSpec field(s) in dict: {sorted(unknown)}")
        return cls(**d)


# ---------------------------------------------------------------------------
# the deprecation shim every entry point shares
# ---------------------------------------------------------------------------

def resolve_spec(spec=None, *, caller: str, stacklevel: int = 3,
                 **legacy) -> CompileSpec:
    """Normalize ``(spec | legacy kwargs) -> CompileSpec`` (one release).

    The new calling convention passes a :class:`CompileSpec` (or nothing,
    for the canonical defaults).  The old convention — loose ``n_unit``
    / ``alloc`` / ``opcode_sort`` / ``fuse_levels`` / ``optimize`` /
    ``max_gates`` kwargs, or a bare int where the spec goes (the old
    positional ``n_unit``) — still works but emits a
    ``DeprecationWarning`` (message prefixed :data:`DEPRECATION_PREFIX`)
    attributed to the caller via ``stacklevel``.  Unspecified legacy
    kwargs take the CANONICAL defaults, not the old per-entry-point ones
    (the alloc/optimize default unification; see CHANGES.md for PR 5).

    Mixing a spec with legacy kwargs is ambiguous and raises
    ``TypeError``.  Entry points pass their legacy kwargs with the
    module-level ``_UNSET`` sentinel as "not given" so an explicit
    ``optimize=None`` (legal old spelling of "no optimization") is
    still honoured.
    """
    given = {k: v for k, v in legacy.items() if v is not _UNSET}
    if isinstance(spec, CompileSpec):
        if given:
            raise TypeError(
                f"{caller}: pass either a CompileSpec or legacy kwargs "
                f"({sorted(given)}), not both")
        return spec
    if spec is not None:
        if isinstance(spec, bool) or not isinstance(spec, int):
            raise TypeError(
                f"{caller}: expected a CompileSpec (or a legacy int "
                f"n_unit), got {type(spec).__name__}")
        if "n_unit" in given:
            raise TypeError(f"{caller}: n_unit given both positionally "
                            "and by keyword")
        given["n_unit"] = int(spec)
    if not given:
        return CompileSpec()
    # map old spellings onto the spec fields; optimize=None meant "none"
    if "optimize" in given and given["optimize"] is None:
        given["optimize"] = "none"
    warnings.warn(
        f"{DEPRECATION_PREFIX}: {caller}({', '.join(sorted(given))}=...) is "
        f"deprecated; pass a repro.core.spec.CompileSpec instead "
        f"(unspecified knobs now take the canonical CompileSpec defaults)",
        DeprecationWarning, stacklevel=stacklevel)
    return CompileSpec(**given)
