# Copied from src/repro/core/compiler.py; only the repro imports differ.
"""The unified compile facade: ``LogicCompiler.compile(graph, spec)``.

Before the :class:`~repro.core.spec.CompileSpec` redesign the repo had
three divergent compile paths — direct ``scheduler.compile_graph``,
``partition`` + ``compile_partitions`` for over-budget graphs, and the
serving registry's private ``ProgramCache`` miss path — each re-threading
the same loose kwargs and re-implementing the optimize/partition/permute
bookkeeping.  :class:`LogicCompiler` is the one place that sequence
lives:

    optimize (core/opt.py pipeline)
      -> resolve n_unit="auto" (optimizer.binary_search on the
         post-optimization eq. 23 stats — the paper's §7.2 design-space
         search as a spec value)
        -> partition if the budget binds (core/partition.py, with
           per-cluster re-optimization)
          -> schedule each program (core/scheduler.py)
            -> output permutation for word-level re-assembly

and :class:`CompiledArtifact` is the one result type: the resolved spec,
the post-optimization graph, the program pipeline, the output
permutation, and the compile/DSE provenance.  ``serve.ProgramCache``
compiles through this facade (keying entries on
``spec.cache_key()``); direct callers get the same artifact without a
cache.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.calibrate import (Calibration, CalibrationError,
                                  WallClockModel)
from repro_torch.core.cost_model import CostModel, FfclStats, LayerLoad
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.optimizer import SearchResult, binary_search
from repro_torch.core.partition import (compile_partitions, output_permutation,
                                  partition)
from repro_torch.core.scheduler import LogicProgram, compile_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.core.verify import (ScheduleVerificationError, certify_remap,
                               effective_mode, verify_artifact)


@dataclass(frozen=True)
class CompiledArtifact:
    """Everything one compilation of (graph, spec) produced.

    ``spec`` is the *resolved* target — ``n_unit`` is always concrete
    (``"auto"`` requests record the ``binary_search`` pick, with the
    probe trail in ``search``) — so ``spec.cache_key()`` plus
    ``graph.fingerprint()`` names this artifact exactly, and
    ``spec.to_dict()`` is what benchmarks/reports persist.
    """

    spec: CompileSpec                      # resolved (concrete n_unit)
    graph: LogicGraph                      # post-optimization graph
    programs: tuple[LogicProgram, ...]     # 1 = monolithic, >1 = pipeline
    output_perm: np.ndarray                # concat(part outs)[perm] == orig
    compile_s: float = 0.0
    search: SearchResult | None = field(default=None, compare=False)
    #: how a multi-program artifact composes: ``"parallel"`` (partition
    #: pipeline — every program reads the primary inputs, outputs
    #: re-assembled through ``output_perm``) or ``"chain"`` (layer stack —
    #: program k's outputs feed program k+1; perm is identity).
    mode: str = "parallel"

    @property
    def partitioned(self) -> bool:
        return len(self.programs) > 1

    @property
    def program(self) -> LogicProgram:
        """The single program of a monolithic artifact."""
        if self.partitioned:
            raise ValueError(
                f"artifact is a {len(self.programs)}-program pipeline; "
                "iterate .programs")
        return self.programs[0]

    @property
    def n_inputs(self) -> int:
        return self.graph.n_inputs

    @property
    def n_outputs(self) -> int:
        return self.graph.n_outputs

    def device_arrays(self) -> list[dict]:
        """Per-program device arrays (memoized per program object by the
        kernel layer; imported lazily so core stays importable without
        jax)."""
        from repro_torch.kernels.logic_dsp.ops import program_arrays
        return [program_arrays(p) for p in self.programs]

    def megaprogram(self):
        """The artifact's whole pipeline flattened into one
        :class:`~repro.core.scheduler.MegaProgram` for single-launch
        execution (memoized on the artifact; the engine's runner path).
        Partitioned artifacts fuse with the output permutation applied
        in-kernel; chain artifacts fuse stage-to-stage handoff."""
        mega = getattr(self, "_megaprogram", None)
        if mega is None:
            from repro_torch.core.partition import mega_pipeline
            mega = mega_pipeline(self.programs, self.output_perm,
                                 mode=self.mode, name=self.graph.name)
            object.__setattr__(self, "_megaprogram", mega)
        return mega

    def execute(self, inputs: np.ndarray) -> np.ndarray:
        """Numpy-oracle execution of the whole artifact (every program
        over the same input slab, re-assembled in original output
        order — or chained stage-to-stage for ``mode="chain"``) — the
        semantic contract the kernel/serving paths are tested against."""
        from repro_torch.core.scheduler import execute_program_np
        if self.mode == "chain":
            h = np.asarray(inputs)
            for p in self.programs:
                h = execute_program_np(p, h)
            return h
        outs = [execute_program_np(p, inputs) for p in self.programs]
        cat = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)
        return cat[:, self.output_perm]

    def stats(self) -> dict:
        per_prog = [p.stats() for p in self.programs]
        search = {}
        if self.search is not None:
            search = {"search_probes": len(self.search.evaluations),
                      "search_objective": self.search.objective}
            if self.search.alt is not None:
                # the other objective's pick, for DSE provenance
                search["alt_objective"] = self.search.alt.objective
                search["alt_n_unit"] = self.search.alt.best_n_unit
        return {
            "spec": self.spec.to_dict(),
            "n_programs": len(self.programs),
            "n_gates": sum(s["n_gates"] for s in per_prog),
            "n_steps": sum(s["n_steps"] for s in per_prog),
            "depth": max((s["depth"] for s in per_prog), default=0),
            "compile_s": self.compile_s,
            **search,
        }


class LogicCompiler:
    """Compile :class:`LogicGraph` s against declarative
    :class:`CompileSpec` targets.

    The constructor holds only the *design-space context* for
    ``n_unit="auto"`` resolution — the cost model and search bounds of
    the paper's §7.2 binary search, plus the SIMD batch the latency
    model assumes.  Everything about one compilation lives on the spec.
    """

    def __init__(self, model: CostModel | None = None,
                 n_unit_max: int = 4096, n_unit_min: int = 1,
                 n_input_vectors: int = 1024, fault_hook=None,
                 calibration: Calibration | None = None,
                 verify: str | None = None):
        self.model = model or CostModel()
        self.n_unit_max = n_unit_max
        self.n_unit_min = n_unit_min
        self.n_input_vectors = n_input_vectors
        # Compiler-level static-verification default (core/verify.py):
        # applied when a spec does not opt in itself (spec.verify="off").
        # "compile"/"full" prove every artifact this facade emits and
        # raise ScheduleVerificationError on any Diagnostic.
        if verify not in (None, "off", "compile", "load", "full"):
            raise ValueError(f"unknown verify mode {verify!r}")
        self.verify = verify
        # Fitted per-phase wall-clock calibration (core/calibrate.py).
        # Required for specs with objective="wallclock"; when present,
        # cycles-objective resolutions also record the wallclock pick in
        # the search provenance (SearchResult.alt) and vice versa.
        self.calibration = calibration
        # Optional ``hook(graph, spec)`` called at the top of every
        # :meth:`compile` — the seam fault injection uses to raise a
        # :class:`~repro.core.errors.TransientCompileError` with seeded
        # determinism (serve.frontdoor.FaultPolicy) so retry paths are
        # testable.  ``None`` (default) costs one attribute check.
        self.fault_hook = fault_hook

    # -- n_unit="auto" ------------------------------------------------------

    def resolve(self, graph: LogicGraph, spec: CompileSpec, *,
                assume_optimized: bool = False
                ) -> tuple[CompileSpec, SearchResult | None]:
        """Resolve ``n_unit="auto"`` to the ``binary_search`` Pareto
        pick for ``graph`` (a no-op for concrete specs).

        The search probes the POST-optimization eq. 23 stats
        (``FfclStats.from_graph(optimized=spec)``) — the gate counts the
        scheduler will actually emit.  ``assume_optimized=True`` skips
        re-running the pipeline when ``graph`` already reflects
        ``spec.optimize`` (e.g. the serving registry's memoized
        optimized graph).

        ``spec.objective`` picks the search objective: ``"cycles"``
        descends the modelled eq. 22 cycles (the default, and identical
        to the pre-knob behavior); ``"wallclock"`` descends the
        calibrated per-phase seconds model and requires this compiler to
        carry a fitted ``Calibration`` — without one it raises
        :class:`~repro.core.calibrate.CalibrationError` (callers fall
        back to ``objective="cycles"`` explicitly; the serving registry
        does so with a warning).  When a calibration is present, BOTH
        objectives' picks are resolved and the non-chosen one is
        recorded as ``search.alt`` — the DSE provenance shows what the
        other objective would have picked.
        """
        if spec.resolved:
            return spec, None
        stats = FfclStats.from_graph(
            graph, optimized=False if assume_optimized else spec)
        layers = [LayerLoad(stats, 1, self.n_input_vectors)]
        bounds = dict(n_unit_max=self.n_unit_max, n_unit_min=self.n_unit_min)
        if spec.objective == "wallclock":
            if self.calibration is None:
                raise CalibrationError(
                    "spec requests objective='wallclock' but this "
                    "LogicCompiler has no calibration; fit one "
                    "(core/calibrate.py, tools/calibrate.py) or use "
                    "objective='cycles'")
            wc = WallClockModel(self.calibration, self.model)
            search = binary_search(wc, layers, objective="wallclock",
                                   **bounds)
            search.alt = binary_search(self.model, layers, **bounds)
        else:
            search = binary_search(self.model, layers, **bounds)
            if self.calibration is not None:
                wc = WallClockModel(self.calibration, self.model)
                search.alt = binary_search(wc, layers,
                                           objective="wallclock", **bounds)
        return spec.with_(n_unit=search.best_n_unit), search

    # -- the one compile path -----------------------------------------------

    def compile(self, graph: LogicGraph, spec: CompileSpec | None = None, *,
                assume_optimized: bool = False) -> CompiledArtifact:
        """Compile ``graph`` to a :class:`CompiledArtifact` per ``spec``
        (canonical defaults when omitted).

        Unifies the three historical paths: the optimize stage runs
        once up front (unless ``assume_optimized``), ``"auto"`` unit
        counts resolve via :meth:`resolve`, a binding ``max_gates``
        budget routes through output-cone partitioning with per-cluster
        re-optimization, and partition sub-programs are scheduled with
        the optimize stage stripped (their cones are already optimized
        — re-running the pipeline would be pure waste).
        """
        spec = spec if spec is not None else CompileSpec()
        if self.fault_hook is not None:
            self.fault_hook(graph, spec)
        t0 = time.perf_counter()
        verifying = effective_mode(spec.verify, self.verify) in (
            "compile", "full")
        pipeline = spec.pipeline
        if assume_optimized or pipeline is None:
            g = graph
        elif verifying:
            # keep the composed wire remap so the pass pipeline's own
            # certificate (total, in-range output map — V115) is proven
            # alongside the schedule; certify=True additionally checks
            # each individual pass so a broken rewrite names its pass
            opt = pipeline.run(graph, certify=True)
            remap_diags = certify_remap(graph, opt.graph, opt.remap,
                                        label=f"pipeline({graph.name})")
            if remap_diags:
                from repro_torch.core.verify import VerifyReport
                raise ScheduleVerificationError(VerifyReport(
                    target=graph.name, diagnostics=tuple(remap_diags)))
            g = opt.graph
        else:
            g = pipeline.run(graph).graph
        spec, search = self.resolve(g, spec, assume_optimized=True)
        mono = spec.with_(optimize="none", max_gates=None)
        parts = None
        if spec.max_gates is not None and g.n_gates > spec.max_gates:
            # per-cluster re-optimization: extraction re-exposes slack
            # inside duplicated cones that global passes could not see
            parts = partition(g, spec)
            programs = tuple(compile_partitions(parts, mono))
            perm = output_permutation(parts, g.n_outputs)
        else:
            programs = (compile_graph(g, mono),)
            perm = np.arange(g.n_outputs, dtype=np.int64)
        artifact = CompiledArtifact(
            spec=spec, graph=g, programs=programs, output_perm=perm,
            compile_s=time.perf_counter() - t0, search=search)
        if verifying:
            # a fresh artifact failing its own static proof is a
            # compiler bug — loud, typed, never served; the clusters
            # just scheduled are handed over so the proof does not pay
            # for a redundant partition re-derivation (load-path
            # verification re-derives — there the clusters are not
            # in hand)
            verify_artifact(artifact, parts=parts).raise_if_failed()
        return artifact
