# CompiledEntry, ProgramCache, LogicRequest and _Chunk are copied from
# src/repro/serve/logic_engine.py (only the imports and ProgramCache's
# calibration record, named by device, differ); LogicEngine is its PyTorch
# port on one or more devices.
"""Batched serving engine for compiled logic programs (``LogicEngine``).

Three layers, as in the reference package:

1. **Program registry** (:class:`ProgramCache`) — compiled programs keyed
   by ``(graph fingerprint, CompileSpec.cache_key())``; repeat traffic for
   a structurally identical FFCL never recompiles.  Misses compile through
   the one :class:`~repro_torch.core.compiler.LogicCompiler` facade.

2. **Slot/word batching** (:class:`LogicEngine` + :class:`RowRuns`) —
   incoming bit-vector requests are packed into the sample rows of one
   fixed-capacity ``(capacity, n_inputs)`` batch, i.e. the ``32 * W``
   samples of the packed ``(n_wires, W)`` word layout.  One invocation
   amortizes pack -> program(s) -> unpack across every queued request;
   freed rows are recycled between invocation waves.  Rows are held as
   ``[lo, hi)`` runs (``batcher.SlotTable``'s admission with ranges for
   row indices), so a chunk's samples are copied in and out by slice, one
   copy a run; a wave that is one chunk filling the whole batch from
   C-contiguous, writeable inputs hands those inputs to the runner as
   they are.

3. **Execution** — each wave moves the ``(capacity, n_inputs)`` slab to
   the engine's device once (on CUDA through reused pinned buffers, a
   chunk of rows at a time), packs it there, runs the artifact's whole
   :class:`~repro_torch.core.scheduler.MegaProgram` (monolithic,
   partitioned or chained) in ONE launch of the CUDA mega kernel, and
   unpacks.  Across devices (the reference's ``shard_map`` over a 1-axis
   mesh) the slab's rows split into one contiguous block a device, the
   layout of ``batch_pspec``'s ``P("data", None)``: each block takes the
   same path, through buffers of its own, on its device's own stream, and
   the blocks come back in order — one launch a shard a wave.

Requests are one-shot (combinational logic has no decode loop): a request
completes in the first invocation wave it is admitted to.
"""
from __future__ import annotations

import bisect
import threading
import time
import warnings
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.artifact_store import ArtifactStore, store_key
from repro_torch.core.calibrate import CalibrationError
from repro_torch.core.compiler import CompiledArtifact, LogicCompiler
from repro_torch.core.errors import PermanentCompileError
from repro_torch.core.gate_ir import LogicGraph, compose_graphs
from repro_torch.core.packing import WORD_BITS
from repro_torch.core.scheduler import LogicProgram, compile_graph
from repro_torch.core.spec import CompileSpec, resolve_spec, _UNSET
from repro_torch.core.verify import effective_mode, verify_artifact
from repro_torch.kernels.logic_dsp.ops import (calibration_name, mega_arrays,
                                               mega_forward_words, pack_bits,
                                               resolve_device, unpack_bits)
from repro_torch.kernels.native import launch_count


# ---------------------------------------------------------------------------
# device scope of a worker thread
# ---------------------------------------------------------------------------

def current_stream(device: torch.device):
    """The CUDA stream the calling thread queues ``device``'s work on, or
    None for the CPU."""
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


@contextmanager
def device_scope(device: torch.device, stream=None):
    """Run the block with ``device`` current and, on CUDA, ``stream``
    current on it.  A new thread starts on CUDA device 0 and its default
    stream whatever its creator had, so a thread that serves a caller's
    engine enters this with the caller's device and stream."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


# ---------------------------------------------------------------------------
# program registry
# ---------------------------------------------------------------------------

def _resolve_cache_spec(spec, alloc, max_gates, n_unit, pipeline, *,
                        caller: str) -> CompileSpec:
    """The registry's deprecation shim: the pre-spec convention was
    ``(graph, n_unit, alloc, max_gates, pipeline=...)`` with ``alloc``/
    ``max_gates`` positional and the pass pipeline under the ``pipeline``
    name (``None`` = raw) — normalize all of that onto the spec's
    ``optimize`` field before handing to :func:`resolve_spec`."""
    optimize = _UNSET
    if pipeline is not _UNSET:
        optimize = "none" if pipeline is None else pipeline
    return resolve_spec(spec, caller=caller, stacklevel=4, n_unit=n_unit,
                        alloc=alloc, max_gates=max_gates, optimize=optimize)


@dataclass
class CompiledEntry:
    """One registry entry: a :class:`CompiledArtifact` plus its runners.

    The artifact is the facade's one result type (resolved spec,
    post-optimization graph, program pipeline, output permutation); the
    entry adds the registry key and the lazily-attached fused jit
    runners, keyed by engine execution config (mesh/shard/backend/
    capacity) so engines sharing a cache never run another engine's
    trace — evicted with the entry.
    """

    key: tuple
    artifact: CompiledArtifact
    runners: dict = field(default_factory=dict)

    @property
    def spec(self) -> CompileSpec:
        return self.artifact.spec

    @property
    def programs(self) -> tuple[LogicProgram, ...]:
        return self.artifact.programs

    @property
    def output_perm(self) -> np.ndarray:
        return self.artifact.output_perm

    @property
    def n_inputs(self) -> int:
        return self.artifact.n_inputs

    @property
    def n_outputs(self) -> int:
        return self.artifact.n_outputs

    @property
    def compile_s(self) -> float:
        return self.artifact.compile_s

    @property
    def partitioned(self) -> bool:
        return self.artifact.partitioned


class ProgramCache:
    """LRU registry of compiled logic programs.

    Keying contract (documented in DESIGN.md §5/§8): the key is
    ``(fingerprint, spec.cache_key())`` — the graph's structural
    identity plus the one canonical :meth:`CompileSpec.cache_key`
    (which replaced the registry's hand-built tuple), taken with
    ``optimize`` stripped to ``"none"`` since the pipeline's whole
    effect is absorbed into the fingerprint — where the fingerprint is
    taken **after** gate-level optimization when the spec carries a
    pass pipeline:

      * ``fingerprint()`` hashes inputs/gates/outputs but NOT the name, so
        structurally identical graphs from different producers share one
        compiled program;
      * with ``spec.optimize`` active, the key uses the
        *post-optimization* fingerprint: two raw graphs that rewrite to
        the same optimized netlist — e.g. the same NullaNet layer
        synthesized by two workers with different dead fanin — hit ONE
        cache entry instead of compiling twice;
      * the spec key is normalized per graph (:meth:`CompileSpec
        .normalize`): an unbinding partition budget keys as ``None``,
        and ``n_unit="auto"`` is resolved to its ``binary_search`` pick
        before keying, so a key always names one concrete program
        pipeline.

    Optimization itself is memoized per ``(raw fingerprint,
    spec.optimize_key)``, so the serving hot path stays O(1) per repeat
    request: the raw fingerprint is memoized on the graph object, the
    optimized graph on the cache — the pass pipeline runs once per
    distinct raw structure, not once per request.  Compilation on a
    miss goes through the one :class:`~repro.core.compiler
    .LogicCompiler` facade (no private compile path anymore).

    Device arrays ride along for free: ``program_arrays`` memoizes on the
    (immutable) program object, and each engine attaches its fused jit
    runner to the entry keyed by its execution config (mesh, shard,
    backend, capacity — engines sharing a cache never run another
    engine's trace), so eviction releases program, arrays, and traces
    together.
    """

    def __init__(self, max_entries: int | None = None,
                 compiler: LogicCompiler | None = None,
                 store: ArtifactStore | None = None, device=None):
        self.max_entries = max_entries
        self.compiler = compiler or LogicCompiler()
        # Optional durable backing (core/artifact_store.py): an
        # in-memory miss consults the store BEFORE compiling (fleet warm
        # start — a fresh process serves its first request with zero
        # compiles from a populated store), and a compile writes through
        # so sibling processes never repeat it.
        self.store = store
        # The device whose calibration record a store-backed cache loads;
        # an engine on another device refuses the cache (LogicEngine).
        # None when neither a store nor a device is named: nothing in the
        # cache then depends on a device.
        self.device = None if store is None and device is None else \
            resolve_device(device)
        # One reentrant lock serializes get/peek/evict and both memos:
        # engines sharing a cache from threads (the front door steps the
        # engine in an executor; the artifact-store warmers will too)
        # must not race LRU eviction against entry construction.
        # Compilation runs UNDER the lock — a duplicate concurrent miss
        # would compile the same program twice and momentarily double
        # device memory, which is worse than briefly serializing misses
        # (hits only touch an OrderedDict move_to_end).
        self._lock = threading.RLock()
        self._entries: OrderedDict[tuple, CompiledEntry] = OrderedDict()
        # (raw fingerprint, spec.optimize_key) -> optimized LogicGraph;
        # LRU-bounded looser than the entries (graphs are cheap next to
        # compiled programs + device arrays, and a memo hit is what keeps
        # re-admitted evictees from re-running the pass pipeline).
        self._opt_memo: OrderedDict[tuple, LogicGraph] = OrderedDict()
        # (post-opt fingerprint, spec.objective) -> resolved n_unit for
        # n_unit="auto" specs: the design-space search (levelize +
        # binary_search probes) must run once per distinct structure,
        # not once per request — the hot path stays O(1) per repeat.
        # The objective is part of the key because "cycles" and
        # "wallclock" searches legitimately pick different unit counts
        # for the same structure; the cache's single compiler fixes the
        # remaining search inputs.
        self._auto_memo: OrderedDict[tuple, int] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.compiles = 0           # actual compiler invocations (a miss
        #                             served from the store never compiles
        #                             — warm-start tests pin this to 0)
        self.compile_failures = 0
        self.store_hits = 0         # misses satisfied by a verified load
        self.store_misses = 0       # store consulted, no entry published
        self.store_failures = 0     # corrupt entry: quarantined, recompiled
        self.store_saves = 0        # write-through persists after compile
        self.store_save_failures = 0
        self.verifies = 0           # schedule-verifier runs (verify="load"/
        #                             "full" load paths + chain compiles)
        self.verify_failures = 0    # verifier-rejected loads: quarantined,
        #                             recompiled (DESIGN.md §13)
        # Warm-start the wall-clock calibration too: a compiler with no
        # fitted calibration picks up the store's persisted fit for the
        # device its engines run on (``ops.calibration_name``), so a
        # fresh process can serve objective="wallclock" specs
        # with zero re-fits (fit_count() == 0 — same contract as the
        # zero-compile warm start).  Best-effort: a corrupt record is
        # quarantined at the store layer and serving degrades to the
        # cycles objective (see :meth:`_resolved`).
        if store is not None and self.compiler.calibration is None:
            try:
                self.compiler.calibration = store.load_calibration(
                    calibration_name(self.device))
            except PermanentCompileError as exc:
                self.store_failures += 1
                warnings.warn(
                    f"calibration warm start failed: {exc!r}; "
                    "objective='wallclock' will fall back to 'cycles'",
                    RuntimeWarning, stacklevel=2)

    @property
    def _opt_memo_bound(self) -> int | None:
        return None if self.max_entries is None else 8 * self.max_entries

    def _optimized(self, graph: LogicGraph, spec: CompileSpec) -> LogicGraph:
        """The graph the registry compiles and keys on (memoized)."""
        pipeline = spec.pipeline
        if pipeline is None:
            return graph
        memo_key = (graph.fingerprint(), spec.optimize_key)
        with self._lock:
            cached = self._opt_memo.get(memo_key)
            if cached is not None:
                self._opt_memo.move_to_end(memo_key)
                return cached
            opt = pipeline.run(graph).graph
            self._opt_memo[memo_key] = opt
            bound = self._opt_memo_bound
            if bound is not None:
                while len(self._opt_memo) > bound:
                    self._opt_memo.popitem(last=False)
            return opt

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    @staticmethod
    def key_of(graph: LogicGraph, spec: CompileSpec | int | None = None,
               alloc=_UNSET, max_gates=_UNSET, *, n_unit=_UNSET,
               pipeline=_UNSET) -> tuple:
        """Registry key for ``(graph, spec)`` — pass the graph the
        registry will actually compile (i.e. the *post-optimization*
        graph when the spec carries a pipeline; :meth:`get` handles that
        internally) and a spec with a concrete ``n_unit``.

        The spec side is ``cache_key()`` with ``optimize`` stripped: the
        pipeline's entire effect is absorbed into the post-optimization
        fingerprint, so a ``optimize="default"`` engine submitting a raw
        graph and an ``optimize="none"`` engine submitting the already-
        optimized netlist land on ONE entry (sharing programs, device
        arrays, and runners) instead of compiling the byte-identical
        program twice."""
        spec = _resolve_cache_spec(spec, alloc, max_gates, n_unit, pipeline,
                                   caller="ProgramCache.key_of")
        return (graph.fingerprint(),
                spec.normalize(graph).with_(optimize="none").cache_key())

    def peek(self, key: tuple) -> CompiledEntry | None:
        """Entry for ``key`` without compiling, counting, or LRU-touching."""
        with self._lock:
            return self._entries.get(key)

    def evict(self, key: tuple | None = None) -> tuple | None:
        """Drop one entry (programs + device arrays + runners together).

        ``key=None`` evicts the least-recently-used entry — the knob
        fault injection (``serve.frontdoor.FaultPolicy.evict_rate``)
        turns to simulate an eviction storm; a concrete ``key`` drops
        that entry (e.g. to force a recompile after an external
        invalidation). Returns the evicted key, or ``None`` when there
        was nothing to evict.  Engines with queued requests for an
        evicted entry recompile from the retained graph
        (:meth:`LogicEngine.step`) — eviction never wedges a queue.
        """
        with self._lock:
            if key is None:
                if not self._entries:
                    return None
                key, _ = self._entries.popitem(last=False)
                return key
            return key if self._entries.pop(key, None) is not None else None

    def get(self, graph: LogicGraph, spec: CompileSpec | int | None = None,
            alloc=_UNSET, max_gates=_UNSET, *, n_unit=_UNSET,
            pipeline=_UNSET) -> CompiledEntry:
        """Return (compiling on miss) the program pipeline for
        ``(graph, spec)``.

        The graph is optimized per ``spec.optimize`` first (memoized)
        and the entry is keyed on the optimized structure; budget
        normalization, ``n_unit="auto"`` resolution, and partitioning
        then see post-optimization gate counts — a graph whose
        optimized form fits ``spec.max_gates`` serves monolithically
        even when its raw form would have split.  Loose ``n_unit``/
        ``alloc``/``max_gates``/``pipeline`` arguments are the
        deprecated pre-spec convention.
        """
        spec = _resolve_cache_spec(spec, alloc, max_gates, n_unit, pipeline,
                                   caller="ProgramCache.get")
        with self._lock:
            raw_fp, req_spec = graph.fingerprint(), spec
            entry = self._alias_fast_path(graph, raw_fp, spec)
            if entry is not None:
                return entry
            graph = self._optimized(graph, spec)
            spec = self._resolved(graph, spec)
            # normalize BEFORE compiling so the artifact's recorded spec
            # is exactly what the key names (an unbinding budget keys —
            # and records — as None; optimize strips to "none" because
            # its whole effect lives in the post-optimization
            # fingerprint — see :meth:`key_of` — and
            # ``assume_optimized`` below means the facade never re-runs
            # it anyway)
            spec = spec.normalize(graph).with_(optimize="none")
            key = (graph.fingerprint(), spec.cache_key())
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                return entry
            self.misses += 1
            artifact = self._store_load(graph.fingerprint(), spec)
            if artifact is None:
                try:
                    self.compiles += 1
                    artifact = self.compiler.compile(graph, spec,
                                                     assume_optimized=True)
                except Exception:
                    # a failed compile leaves no entry behind: the next
                    # attempt (the front door's retry-with-backoff on
                    # transient failures) recompiles from scratch
                    self.compile_failures += 1
                    raise
                self._store_save(artifact, raw_fp, req_spec)
            entry = CompiledEntry(key=key, artifact=artifact)
            self._entries[key] = entry
            if self.max_entries is not None:
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
            return entry

    def get_chain(self, graphs, spec: CompileSpec | None = None
                  ) -> CompiledEntry:
        """Return (compiling on miss) a *chain* pipeline entry: the stage
        graphs compiled separately and served as ONE chain-mode megakernel
        launch (stage k's outputs feed stage k+1 in-kernel).

        Keyed on ``("chain", stage post-opt fingerprints...)`` plus the
        normalized spec key, so the same layer stack submitted by any
        producer shares one entry — distinct from the composed graph's
        monolithic entry, which flattens the stage structure.  Each stage
        is optimized per ``spec.optimize`` (memoized like :meth:`get`;
        passes preserve the per-stage I/O interface, so the chain widths
        still match).  Constraints: ``n_unit`` must be concrete and
        ``max_gates`` is ignored (a budget that binds needs output-cone
        partitioning of the composed graph — serve that via :meth:`get`).
        Chain entries are in-memory only (no artifact-store read/write:
        the store persists single-graph artifacts).
        """
        graphs = tuple(graphs)
        if not graphs:
            raise ValueError("get_chain needs at least one stage graph")
        spec = resolve_spec(spec, caller="ProgramCache.get_chain")
        if not spec.resolved:
            raise ValueError(
                "get_chain needs a concrete n_unit: per-stage "
                "n_unit='auto' resolution has no single spec to key on — "
                "serve the composed graph via get() instead")
        with self._lock:
            opt = [self._optimized(g, spec) for g in graphs]
            mono = spec.with_(optimize="none", max_gates=None)
            key = (("chain",) + tuple(g.fingerprint() for g in opt),
                   mono.cache_key())
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                return entry
            self.misses += 1
            self.compiles += 1
            t0 = time.perf_counter()
            try:
                programs = tuple(compile_graph(g, mono) for g in opt)
                composed = compose_graphs(
                    list(opt), name="+".join(g.name for g in graphs))
                artifact = CompiledArtifact(
                    spec=mono, graph=composed, programs=programs,
                    output_perm=np.arange(composed.n_outputs,
                                          dtype=np.int64),
                    compile_s=time.perf_counter() - t0, mode="chain")
                if effective_mode(spec.verify,
                                  getattr(self.compiler, "verify", None)
                                  ) in ("compile", "full"):
                    # chain entries bypass the LogicCompiler facade, so
                    # the verify="compile" gate lives here
                    self.verifies += 1
                    verify_artifact(artifact).raise_if_failed()
            except Exception:
                self.compile_failures += 1
                raise
            entry = CompiledEntry(key=key, artifact=artifact)
            self._entries[key] = entry
            if self.max_entries is not None:
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
            return entry

    def _alias_fast_path(self, graph: LogicGraph, raw_fp: str,
                         spec: CompileSpec) -> CompiledEntry | None:
        """Warm start WITHOUT the pass pipeline: on first contact with a
        raw structure, resolve ``(raw fingerprint, requested spec)``
        through the store's alias records straight to the verified
        canonical artifact — skipping the optimizer run the canonical
        (post-opt) address would otherwise force, which is the dominant
        cold-start cost for ``optimize="default"`` specs.

        ``None`` falls through to the normal path: no store, nothing to
        skip (``optimize="none"`` — the canonical lookup covers it),
        structure already seen in this process (the opt memo makes the
        normal path O(1)), a custom pipeline (no declarative identity),
        an alias miss, or a corrupt alias (counted, quarantined at the
        store layer, recompiled here)."""
        if self.store is None or spec.pipeline is None:
            return None
        if (raw_fp, spec.optimize_key) in self._opt_memo:
            return None
        try:
            spec.to_dict()
        except ValueError:
            return None
        try:
            artifact = self.store.load_alias(raw_fp, spec)
        except PermanentCompileError:
            self.store_failures += 1
            return None
        if artifact is None:
            return None
        # verify BEFORE seeding the memos: a schedule-invalid artifact's
        # graph must never be trusted as "the optimized form" either
        if not self._verify_loaded(artifact, spec,
                                   label=f"alias fp={raw_fp[:12]}"):
            return None             # falls through to the normal path
        # seed the memos the normal path would have filled, so repeat
        # requests for this structure never leave memory
        opt_fp = artifact.graph.fingerprint()
        self._opt_memo[(raw_fp, spec.optimize_key)] = artifact.graph
        bound = self._opt_memo_bound
        if bound is not None:
            while len(self._opt_memo) > bound:
                self._opt_memo.popitem(last=False)
        if not spec.resolved:
            self._auto_memo[(opt_fp, spec.objective)] = artifact.spec.n_unit
        key = (opt_fp, artifact.spec.cache_key())
        entry = self._entries.get(key)
        if entry is not None:       # admitted meanwhile via another raw form
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        self.store_hits += 1
        entry = CompiledEntry(key=key, artifact=artifact)
        self._entries[key] = entry
        if self.max_entries is not None:
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return entry

    def _verify_loaded(self, artifact: CompiledArtifact,
                       req_spec: CompileSpec, *, label: str) -> bool:
        """Gate a store-loaded artifact behind the static schedule
        verifier (``verify="load"``/``"full"`` — DESIGN.md §13).

        Store checksums prove the bytes round-tripped; the verifier
        proves the *schedule* still computes the recorded graph — the
        one trust hole §10.4 left open (an entry that was wrong when
        written verifies its checksums forever).  A rejected artifact is
        quarantined at the store (so no other process serves it either)
        and ``False`` sends this request to a clean compile: detection
        must degrade the fleet to cold-start latency, never to wrong
        bits.  ``True`` = passed or exempt (mode off/compile-only).
        """
        mode = effective_mode(req_spec.verify,
                              getattr(self.compiler, "verify", None))
        if mode not in ("load", "full"):
            return True
        self.verifies += 1
        report = verify_artifact(artifact)
        if report.ok:
            return True
        self.verify_failures += 1
        qpath = None
        if self.store is not None:
            try:
                qpath = self.store.quarantine(store_key(
                    artifact.graph.fingerprint(), artifact.spec))
            except Exception:           # noqa: BLE001 — quarantine is
                qpath = None            # best-effort; rejection is not
        warnings.warn(
            f"store-loaded artifact rejected by schedule verifier "
            f"({label}): {report.summary()}; quarantined -> {qpath}; "
            "falling back to a clean compile",
            RuntimeWarning, stacklevel=3)
        return False

    def _store_load(self, fingerprint: str, spec: CompileSpec
                    ) -> CompiledArtifact | None:
        """Store-hit-before-compile: a verified artifact, or ``None`` on
        a clean miss / no store.  A corrupt entry is LOUD at the store
        layer (quarantined there) but *recoverable* here: the registry
        counts it and falls back to a clean compile — a bad disk must
        degrade a fleet to cold-start latency, never to wrong bits or a
        crashed server."""
        if self.store is None:
            return None
        try:
            artifact = self.store.load(fingerprint, spec)
        except PermanentCompileError:
            self.store_failures += 1
            return None
        if artifact is None:
            self.store_misses += 1
            return None
        if not self._verify_loaded(artifact, spec,
                                   label=f"entry fp={fingerprint[:12]}"):
            return None             # rejected: caller compiles cleanly
        self.store_hits += 1
        return artifact

    def _store_save(self, artifact: CompiledArtifact,
                    raw_fp: str | None = None,
                    req_spec: CompileSpec | None = None) -> None:
        """Write-through after a compile (best-effort: a full/read-only
        disk costs persistence, not serving).  When the request carried
        a pipeline, an alias record for the RAW identity rides along so
        other processes warm-start without re-running the optimizer."""
        if self.store is None:
            return
        try:
            key = self.store.save(artifact)
            self.store_saves += 1
        except Exception as exc:              # noqa: BLE001 — see docstring
            self.store_save_failures += 1
            warnings.warn(f"artifact-store write-through failed: {exc!r}",
                          RuntimeWarning, stacklevel=3)
            return
        if req_spec is None or req_spec.pipeline is None:
            return
        try:
            req_spec.to_dict()
        except ValueError:                    # custom pipeline: no alias
            return
        try:
            self.store.save_alias(raw_fp, req_spec, key)
        except Exception as exc:              # noqa: BLE001 — best-effort
            self.store_save_failures += 1
            warnings.warn(f"artifact-store alias write failed: {exc!r}",
                          RuntimeWarning, stacklevel=3)

    def _resolved(self, graph: LogicGraph, spec: CompileSpec) -> CompileSpec:
        """Resolve ``n_unit="auto"`` for ``graph`` (memoized): repeat
        requests must not re-run the design-space search.

        A ``wallclock`` objective on a compiler with no fitted
        calibration degrades to the ``cycles`` objective with a
        :class:`RuntimeWarning` — serving must not 500 on a missing
        calibration file; the typed
        :class:`~repro.core.calibrate.CalibrationError` makes the
        fallback explicit and the warning makes it visible."""
        if spec.resolved:
            return spec
        # the search depends only on the (post-opt) graph stats, the
        # objective, and the cache's one compiler
        memo_key = (graph.fingerprint(), spec.objective)
        with self._lock:
            n_unit = self._auto_memo.get(memo_key)
            if n_unit is None:
                try:
                    resolved, _ = self.compiler.resolve(
                        graph, spec, assume_optimized=True)
                except CalibrationError as exc:
                    warnings.warn(
                        f"objective={spec.objective!r} resolution failed "
                        f"({exc}); falling back to objective='cycles'",
                        RuntimeWarning, stacklevel=2)
                    resolved, _ = self.compiler.resolve(
                        graph, spec.with_(objective="cycles"),
                        assume_optimized=True)
                n_unit = resolved.n_unit
                self._auto_memo[memo_key] = n_unit
                bound = self._opt_memo_bound
                if bound is not None:
                    while len(self._auto_memo) > bound:
                        self._auto_memo.popitem(last=False)
            else:
                self._auto_memo.move_to_end(memo_key)
        return spec.with_(n_unit=n_unit)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "compiles": self.compiles,
                    "compile_failures": self.compile_failures,
                    "store_hits": self.store_hits,
                    "store_misses": self.store_misses,
                    "store_failures": self.store_failures,
                    "store_saves": self.store_saves,
                    "store_save_failures": self.store_save_failures,
                    "verifies": self.verifies,
                    "verify_failures": self.verify_failures,
                    "programs": sum(len(e.programs)
                                    for e in self._entries.values())}


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass
class LogicRequest:
    """One bit-vector inference request against a served graph."""

    uid: int
    key: tuple                     # program-cache key it is bound to
    graph: LogicGraph              # retained so eviction can recompile
    inputs: np.ndarray             # (n_samples, n_inputs) bool
    result: np.ndarray             # (n_samples, n_outputs) bool, filled in
    pending_chunks: int = 0
    done: bool = False
    #: stage graphs of a chain request (``serve_chain``), retained so an
    #: LRU-evicted chain entry can recompile; ``None`` = single-graph.
    chain: tuple | None = None

    @property
    def n_samples(self) -> int:
        return int(self.inputs.shape[0])


@dataclass
class _Chunk:
    """A capacity-bounded slice [lo, hi) of a request's samples."""

    req: LogicRequest
    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class RowRuns:
    """Row allocator over a fixed sample capacity that hands out runs.

    ``batcher.SlotTable``'s contract with rows held as ``[lo, hi)`` runs
    instead of row indices: ``acquire(n)`` returns ``None`` exactly when
    ``SlotTable.acquire(n)`` would (fewer than ``n`` rows free), else the
    ``n`` lowest free rows as a list of runs, lowest first; ``release``
    takes such a list back and merges each run with its free neighbours.
    Both cost O(runs), never O(rows).  ``capacity``, ``n_free``,
    ``n_active`` and ``high_water`` mean what they mean on ``SlotTable``,
    and a release raises as there: ``ValueError`` for a row out of range,
    ``RuntimeError`` for a row not held (one that is free, or named twice).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        # free rows: sorted, disjoint, never adjacent
        self._free: list[tuple[int, int]] = [(0, capacity)]
        self._n_free = capacity
        self.high_water = 0

    @property
    def n_free(self) -> int:
        return self._n_free

    @property
    def n_active(self) -> int:
        return self.capacity - self._n_free

    def acquire(self, n: int) -> list[tuple[int, int]] | None:
        """Reserve the ``n`` lowest free rows as runs; None when fewer than
        ``n`` are free."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > self._n_free:
            return None
        free, runs, k, need = self._free, [], 0, n
        while need:
            lo, hi = free[k]
            if hi - lo > need:
                runs.append((lo, lo + need))
                free[k] = (lo + need, hi)
                break
            runs.append((lo, hi))
            need -= hi - lo
            k += 1
        del free[:k]
        self._n_free -= n
        self.high_water = max(self.high_water, self.n_active)
        return runs

    def release(self, runs) -> None:
        """Return runs from :meth:`acquire`; checked whole before any is
        freed, so a release that raises frees nothing."""
        runs = sorted(runs)
        free, end = self._free, 0
        for lo, hi in runs:
            if lo < 0 or hi > self.capacity or hi < lo:
                raise ValueError(f"run [{lo}, {hi}) out of range")
            if lo == hi:
                continue
            i = bisect.bisect_left(free, (lo,))
            if lo < end or (i and free[i - 1][1] > lo):
                raise RuntimeError(f"row {lo} released without being held")
            if i < len(free) and free[i][0] < hi:
                raise RuntimeError(
                    f"row {free[i][0]} released without being held")
            end = hi
        for lo, hi in runs:
            if lo == hi:
                continue
            self._n_free += hi - lo
            i = bisect.bisect_left(free, (lo,))
            if i and free[i - 1][1] == lo:
                i -= 1
                lo = free.pop(i)[0]
            if i < len(free) and free[i][0] == hi:
                hi = free.pop(i)[1]
            free.insert(i, (lo, hi))


#: The slab's bytes a staged chunk carries.  Chunk k's DMA runs while the
#: host fills chunk k+1, but on an H100's host the two share the memory
#: bandwidth: an 18.9 MB slab's fill and DMA took 1.27 ms at 8 MB chunks,
#: 1.31 ms whole, 1.46 ms at 4 MB and 2.27 ms at 1 MB (PERF.md §6).
STAGE_CHUNK_BYTES = 8 << 20


def stage_rows(bits: np.ndarray, host: torch.Tensor,
               dev: torch.Tensor) -> int:
    """Copy ``bits``' rows into ``host`` a chunk of rows at a time, and
    after each chunk enqueue its copy from ``host`` to ``dev`` without
    waiting, so one chunk's transfer runs while the next is filled.  The
    fill is torch's CPU ``copy_``, spread over its intra-op threads.
    Returns the number of chunks."""
    n = len(bits)
    step = max(1, STAGE_CHUNK_BYTES // max(1, bits.shape[1] * bits.itemsize))
    src = torch.from_numpy(bits)
    for lo in range(0, n, step):
        host[lo:lo + step].copy_(src[lo:lo + step])
        dev[lo:lo + step].copy_(host[lo:lo + step], non_blocking=True)
    return -(-n // step)


class _Staging:
    """One thread's reused transfer buffers for one shard of a runner on a
    CUDA device: the block in through a pinned host buffer and a device
    buffer, the outputs back through a pinned host buffer.  Each is
    allocated at the first wave and again only for a block with more
    rows."""

    staged = True

    def __init__(self, device: torch.device):
        self.device = device
        self.host_in = self.dev_in = self.host_out = None
        self.h2d_done = torch.cuda.Event()
        self._out = self._stream = None

    def h2d(self, bits: np.ndarray) -> tuple[torch.Tensor, int]:
        """The block on the device, after its chunks' copies are enqueued
        on the current stream; and the number of chunks."""
        n = len(bits)
        if self.host_in is None or len(self.host_in) < n:
            self.host_in = torch.empty(bits.shape, dtype=torch.bool,
                                       pin_memory=True)
            self.dev_in = torch.empty(bits.shape, dtype=torch.bool,
                                      device=self.device)
        else:
            # the previous wave's copies have left the pinned buffer
            self.h2d_done.synchronize()
        chunks = stage_rows(bits, self.host_in[:n], self.dev_in[:n])
        self.h2d_done.record(torch.cuda.current_stream(self.device))
        return self.dev_in[:n], chunks

    def d2h(self, y: torch.Tensor) -> None:
        """Enqueue ``y``'s copy into the pinned output buffer on the
        current stream, without waiting."""
        if self.host_out is None or len(self.host_out) < len(y):
            self.host_out = torch.empty(y.shape, dtype=torch.bool,
                                        pin_memory=True)
        self._out = self.host_out[:len(y)]
        self._out.copy_(y, non_blocking=True)
        self._stream = torch.cuda.current_stream(self.device)

    def wait(self) -> np.ndarray:
        """The outputs :meth:`d2h` enqueued, once their stream has run up
        to them: a view valid until this thread's next wave."""
        self._stream.synchronize()
        return self._out.numpy()


class _Pageable:
    """The CPU's twin of :class:`_Staging`: the block and its outputs move
    as they are."""

    staged = False

    def __init__(self, device: torch.device):
        self.device = device
        self._out = None

    def h2d(self, bits: np.ndarray) -> tuple[torch.Tensor, int]:
        return torch.from_numpy(bits).to(self.device), 0

    def d2h(self, y: torch.Tensor) -> None:
        self._out = y.cpu()

    def wait(self) -> np.ndarray:
        return self._out.numpy()


def _shard_scope(device: torch.device, stream):
    """A shard's device and stream made current; nothing for a shard on
    the caller's own stream (``stream`` None)."""
    return nullcontext() if stream is None else device_scope(device, stream)


class _Runner:
    """A cache entry's wave on an engine's shards: a callable ``bits ->
    outputs`` (:meth:`LogicEngine._build_runner` builds it).

    ``shards`` lists ``(device, stream)``, a ``None`` stream being the
    caller's current one; shard i takes the slab's rows ``[i * rows,
    (i + 1) * rows)``, ``rows = len(bits) // len(shards)``."""

    def __init__(self, mega, shards: list, use_ref: bool, plan_note: dict):
        self.mega, self.shards = mega, shards
        self.use_ref, self.plan_note = use_ref, plan_note
        self._local = threading.local()

    def transfers(self) -> list:
        """The calling thread's transfer objects, one a shard, made at its
        first wave.  Engines on one device share a cache entry's runner and
        the cache serves threads, so each thread, and each shard, moves its
        block through buffers of its own."""
        mine = getattr(self._local, "transfers", None)
        if mine is None:
            mine = self._local.transfers = [
                (_Staging if dev.type == "cuda" else _Pageable)(dev)
                for dev, _ in self.shards]
        return mine

    def __call__(self, bits: np.ndarray) -> np.ndarray:
        transfers = self.transfers()
        rows = len(bits) // len(self.shards)
        ys = []
        with obs.span("runner"):
            for i, ((dev, stream), io) in enumerate(zip(self.shards,
                                                        transfers)):
                if stream is not None:
                    stream.wait_stream(current_stream(dev))
                with _shard_scope(dev, stream):
                    block = bits[i * rows:(i + 1) * rows]
                    with obs.span("runner.h2d") as sp:
                        x, chunks = io.h2d(block)
                        sp.note(staged=io.staged, chunks=chunks,
                                bytes=block.nbytes)
                    with obs.span("runner.pack") as sp:
                        launched = launch_count("pack")
                        words = pack_bits(x)
                        sp.note(kernel=launch_count("pack") > launched)
                    with obs.span("runner.kernel") as sp:
                        sp.note(**self.plan_note)
                        ow = mega_forward_words(self.mega, words,
                                                use_ref=self.use_ref)
                    with obs.span("runner.unpack") as sp:
                        launched = launch_count("unpack")
                        ys.append(unpack_bits(ow, rows))
                        sp.note(kernel=launch_count("unpack") > launched)
            with obs.span("runner.d2h") as sp:
                sp.note(staged=transfers[0].staged)
                for (dev, stream), io, y in zip(self.shards, transfers, ys):
                    with _shard_scope(dev, stream):
                        io.d2h(y)
                outs = [io.wait() for io in transfers]
                return outs[0] if len(outs) == 1 else np.concatenate(outs)


class LogicEngine:
    """Continuous-batching inference engine over compiled logic programs.

    Args:
      spec: the :class:`~repro_torch.core.spec.CompileSpec` every submitted
        graph is compiled against (canonical defaults when omitted):
        fabric width (``n_unit``; ``"auto"`` resolves per graph via the
        registry's design-space search), address allocation, scheduler
        layout knobs, the gate-level pass pipeline, and the partition
        budget (``max_gates`` — graphs above it are split by output-cone
        clustering and served as one parallel-mode megaprogram).  The
        loose ``n_unit``/``alloc``/``max_gates``/``optimize`` kwargs are
        the deprecated pre-spec convention.
      capacity: samples per invocation wave; rounded up to a multiple of
        ``32 * n_devices`` so every device's block packs whole words.
        Default ``32 * words_per_device * n_devices``.
      words_per_device: sizes the default capacity (W words per device).
      device: where waves run; ``"cuda"`` by default.  The constructor
        raises when no CUDA device is present — ``device="cpu"`` is the
        explicit opt-in to the plain PyTorch executors on the CPU.
      devices: the devices to split each wave over (the counterpart of the
        reference's ``mesh``), all of one type; an entry may repeat (two
        shards on one card, or CPU shards standing in for devices).
        Default: every visible CUDA device when more than one is visible
        and the caller names no ``device`` (or ``shard=True``), else
        ``[device]``.  The first is the engine's ``device``.
      shard: force (True) / forbid (False) the split path; ``None`` (the
        default) splits iff there is more than one device.  ``True`` on
        one device runs the split path there.
      cache: optionally share a :class:`ProgramCache` across engines.
        Mutually exclusive with ``max_programs`` / ``store`` — bound and
        back a shared cache at its own construction.  A cache built for
        another device (its ``device``: the one whose calibration record
        it loaded) raises ``ValueError``.
      max_programs: LRU bound on the engine-owned program cache.
      store: optional :class:`~repro_torch.core.artifact_store.ArtifactStore`
        backing the engine-owned cache.
      max_retained: bound on *completed* requests kept for
        :meth:`result` pickup; beyond it the oldest unclaimed results are
        dropped (FIFO). ``None`` (default) retains until claimed.
      use_ref: run the plain PyTorch executor on ``device`` instead of the
        CUDA kernel (the kernel's yardstick on the card).
    """

    def __init__(self, spec: CompileSpec | int | None = None, *,
                 capacity: int | None = None, words_per_device: int = 4,
                 device=None, devices=None, shard: bool | None = None,
                 cache: ProgramCache | None = None,
                 max_programs: int | None = None,
                 store: ArtifactStore | None = None,
                 max_retained: int | None = None, use_ref: bool = False,
                 n_unit=_UNSET, alloc=_UNSET, max_gates=_UNSET,
                 optimize=_UNSET):
        self.spec = resolve_spec(spec, caller="LogicEngine", n_unit=n_unit,
                                 alloc=alloc, max_gates=max_gates,
                                 optimize=optimize)
        if device is not None and devices is not None:
            raise ValueError("name the devices or one device, not both")
        if devices is None:
            n_cuda = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if device is None and shard is not False and n_cuda > 1:
                devices = [torch.device("cuda", i) for i in range(n_cuda)]
            else:
                devices = [device]
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("devices must name at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"devices must be of one type, got "
                             f"{[str(d) for d in self.devices]}")
        self.device = self.devices[0]
        n_dev = len(self.devices)
        self.use_ref = use_ref
        if cache is not None and max_programs is not None:
            raise ValueError(
                "max_programs bounds the engine-owned cache; bound a shared "
                "ProgramCache at its own construction instead")
        if cache is not None and store is not None:
            raise ValueError(
                "store backs the engine-owned cache; attach an "
                "ArtifactStore to the shared ProgramCache at its own "
                "construction instead")
        if cache is not None and cache.device not in (None, self.device):
            raise ValueError(
                f"the shared ProgramCache was built for {cache.device} and "
                f"carries that device's calibration; this engine runs on "
                f"{self.device}: build a cache with device={self.device}")
        self.cache = cache if cache is not None else \
            ProgramCache(max_programs, store=store, device=self.device)

        quantum = WORD_BITS * n_dev
        if capacity is None:
            capacity = WORD_BITS * words_per_device * n_dev
        self.capacity = -(-capacity // quantum) * quantum
        # auto (None) splits only across more than one device; an explicit
        # shard=True runs the split path even on one device
        self.shard = shard is True or (shard is None and n_dev > 1)

        self.slots = RowRuns(self.capacity)
        self.max_retained = max_retained
        self._queues: OrderedDict[tuple, deque[_Chunk]] = OrderedDict()
        self._requests: dict[int, LogicRequest] = {}
        # Unclaimed completed requests: `_retained` is the O(1)
        # membership truth, `_finished_order` only remembers FIFO age for
        # the max_retained trim (claimed uids are compacted lazily).
        self._finished_order: deque[int] = deque()
        self._retained: set[int] = set()
        self._next_uid = 0
        # execution-config key for per-engine runners on shared cache
        # entries: engines share a runner only on the same devices, in the
        # same order, and the same path
        self._exec_key = (self.capacity, self.shard,
                          tuple(str(d) for d in self.devices), self.use_ref)
        # telemetry
        self.invocations = 0
        self.samples_served = 0
        self._occupancy_sum = 0.0

    # -- compilation-target views (read-only; the spec is the source) -------

    @property
    def n_unit(self):
        return self.spec.n_unit

    @property
    def alloc(self) -> str:
        return self.spec.alloc

    @property
    def max_gates(self) -> int | None:
        return self.spec.max_gates

    @property
    def pipeline(self):
        return self.spec.pipeline

    # -- program / runner plumbing ------------------------------------------

    def _with_runner(self, entry: CompiledEntry) -> CompiledEntry:
        """``entry`` with this engine's runner, built at its first use."""
        if self._exec_key not in entry.runners:
            entry.runners[self._exec_key] = self._build_runner(entry)
        return entry

    def _entry(self, graph: LogicGraph) -> CompiledEntry:
        return self._with_runner(self.cache.get(graph, self.spec))

    def _build_runner(self, entry: CompiledEntry) -> Callable:
        """pack -> mega kernel -> unpack on the engine's shards, ONE kernel
        launch a shard a wave.

        The whole artifact — monolithic, partitioned pipeline, or served
        chain — executes as a single mega-kernel launch: partition
        sub-programs run stage by stage inside the kernel with the output
        permutation applied in-kernel, and chain stages hand off without
        leaving it.  The streams are uploaded once per entry and device
        (memoized by ``mega_arrays``); the only per-wave transfers are the
        ``(capacity, n_inputs)`` bool slab in and the outputs back.

        Without the split there is one shard: the engine's device, on the
        caller's current stream.  Split (``shard``): one shard an entry of
        ``devices``, each on a stream of its own that first waits on the
        caller's stream there; shard i takes the slab's i-th contiguous
        block of rows.  A shard that fails raises.

        Each shard moves its block through transfer objects of its own, one
        set a calling thread (:meth:`_Runner.transfers`, dropped with the
        runner).  On CUDA the block is staged (:class:`_Staging`): the
        host's threads fill a reused pinned buffer a chunk of rows at a
        time (:func:`stage_rows`), each chunk's copy to a reused device
        buffer enqueued as soon as it is filled, and the outputs come back
        through a reused pinned buffer.  With one shard the array returned
        is a view of that buffer, valid until the thread's next call; with
        several it is the shards' outputs concatenated in order.

        The runner is the span ``runner`` (``repro_torch.obs``).  Each shard
        records ``runner.h2d`` (noting whether the block was ``staged``, its
        ``chunks`` and ``bytes``), ``runner.pack``, ``runner.kernel`` (the
        launch's enqueue, noting the launch plan: its ``scratch`` variant,
        ``steps``, ``n_addr`` rows and ``cols`` a block) and
        ``runner.unpack``, the two noting ``kernel``: whether the pack or
        unpack kernel launched, read from its launch count (False for the
        CPU's plain version); then one ``runner.d2h`` enqueues every
        shard's copy back and waits for every shard's stream (noting
        ``staged``).
        """
        mega = entry.artifact.megaprogram()
        for dev in dict.fromkeys(self.devices):
            mega_arrays(mega, dev)
        plan = mega_arrays(mega, self.device)["plan"]
        if self.shard:
            shards = [(d, torch.cuda.Stream(device=d)
                       if d.type == "cuda" else None) for d in self.devices]
        else:
            shards = [(self.device, None)]
        return _Runner(mega, shards, self.use_ref,
                       dict(scratch=plan.scratch, steps=mega.total_steps,
                            n_addr=mega.n_addr, cols=plan.cols))

    # -- request lifecycle ---------------------------------------------------

    def _chain_entry(self, graphs: tuple) -> CompiledEntry:
        return self._with_runner(self.cache.get_chain(graphs, self.spec))

    def submit(self, graph: LogicGraph, bits: np.ndarray) -> int:
        """Queue a request; returns its uid (serve with :meth:`step`)."""
        with obs.span("engine.submit") as sp:
            bits = np.asarray(bits, dtype=bool)
            if bits.ndim != 2 or bits.shape[1] != graph.n_inputs:
                raise ValueError(
                    f"inputs must be (n, {graph.n_inputs}), got {bits.shape}")
            uid = self._admit(self._entry(graph), graph, bits, chain=None)
            sp.note(uid=uid, samples=bits.shape[0])
            return uid

    def submit_chain(self, graphs, bits: np.ndarray) -> int:
        """Queue a request against a *stage chain* (e.g. a classifier's
        per-layer graphs): the stack is compiled per stage and served as
        one chain-mode mega-kernel launch per wave.  Stage widths must
        chain (``graphs[k].n_outputs == graphs[k+1].n_inputs``)."""
        with obs.span("engine.submit") as sp:
            graphs = tuple(graphs)
            if not graphs:
                raise ValueError("submit_chain needs at least one stage graph")
            bits = np.asarray(bits, dtype=bool)
            if bits.ndim != 2 or bits.shape[1] != graphs[0].n_inputs:
                raise ValueError(
                    f"inputs must be (n, {graphs[0].n_inputs}), got "
                    f"{bits.shape}")
            uid = self._admit(self._chain_entry(graphs), graphs[0], bits,
                              chain=graphs)
            sp.note(uid=uid, samples=bits.shape[0])
            return uid

    def _admit(self, entry: CompiledEntry, graph: LogicGraph,
               bits: np.ndarray, chain: tuple | None) -> int:
        uid = self._next_uid
        self._next_uid += 1
        req = LogicRequest(
            uid=uid, key=entry.key, graph=graph, inputs=bits, chain=chain,
            result=np.zeros((bits.shape[0], entry.n_outputs), dtype=bool))
        self._requests[uid] = req
        queue = self._queues.setdefault(entry.key, deque())
        # oversized requests split into capacity-bounded chunks; each chunk
        # is admitted independently so no request can wedge the queue.
        for lo in range(0, max(req.n_samples, 1), self.capacity):
            hi = min(lo + self.capacity, req.n_samples)
            if hi > lo:
                queue.append(_Chunk(req, lo, hi))
                req.pending_chunks += 1
        if req.pending_chunks == 0:      # empty request: trivially done
            req.done = True
            self._retire(uid)
        return uid

    def _retire(self, uid: int) -> None:
        """Track a completed request; drop the oldest unclaimed results
        beyond ``max_retained`` (already-claimed uids are stale deque
        entries and don't count against the bound)."""
        self._finished_order.append(uid)
        self._retained.add(uid)
        if self.max_retained is None:
            return
        while len(self._retained) > self.max_retained:
            old = self._finished_order.popleft()
            if old in self._retained:       # stale (claimed) uids skip
                self._retained.discard(old)
                self._requests.pop(old, None)

    def _compact_finished(self) -> None:
        """Lazy compaction of claimed uids out of ``_finished_order``:
        pop the stale head run, and rebuild outright once stale entries
        outnumber live ones."""
        order, retained = self._finished_order, self._retained
        while order and order[0] not in retained:
            order.popleft()
        if len(order) > 2 * len(retained) + 8:
            self._finished_order = deque(u for u in order if u in retained)

    def _slab(self, n_inputs: int,
              admitted: list[tuple[_Chunk, list]]) -> tuple[np.ndarray, bool]:
        """The wave's ``(capacity, n_inputs)`` bool slab, and whether it is
        the request's own rows (direct).

        A wave that is one chunk over the single run ``[0, capacity)``
        whose rows are C-contiguous and writeable (``torch.from_numpy``
        warns on a read-only array) is its slab: no allocation, no copy.
        Otherwise each run is one slice copy into a new slab, and the rows
        outside the wave's runs are zeroed by slice."""
        if len(admitted) == 1:
            chunk, runs = admitted[0]
            if runs == [(0, self.capacity)]:
                view = chunk.req.inputs[chunk.lo:chunk.hi]
                if view.flags.c_contiguous and view.flags.writeable:
                    return view, True
        bits = np.empty((self.capacity, n_inputs), dtype=bool)
        held = []
        for chunk, runs in admitted:
            src, at = chunk.req.inputs, chunk.lo
            for lo, hi in runs:
                bits[lo:hi] = src[at:at + hi - lo]
                at += hi - lo
            held += runs
        at = 0
        for lo, hi in sorted(held):
            if at < lo:
                bits[at:lo] = False
            at = hi
        bits[at:] = False
        return bits, False

    def step(self) -> list[int]:
        """One invocation wave: admit, execute, scatter back, recycle.

        Serves the longest-waiting non-empty program queue (FIFO across
        keys), admitting chunks into slot rows until the table is full,
        then runs ONE kernel launch for all of them. Returns the uids
        completed this wave.

        Rows are held as runs (:class:`RowRuns`): each chunk's samples go
        into the slab, and its outputs back into the request's result, one
        slice copy a run; a wave that is one whole-capacity chunk runs on
        the request's own rows where they can be handed over as they are
        (:meth:`_slab`).

        The wave is the span ``engine.step`` (``repro_torch.obs``; its
        attributes the wave's number, its samples and the uids it
        completed) over ``engine.admit``, ``engine.slab`` (noting whether
        the slab was ``direct`` and the ``runs`` the wave holds: one slice
        copy each on the slab path), the runner's ``runner`` and
        ``engine.retire``.
        """
        key = next((k for k, q in self._queues.items() if q), None)
        if key is None:
            return []
        queue = self._queues[key]
        entry = self.cache.peek(key)
        if entry is None:
            # LRU-evicted with requests still queued: recompile from the
            # retained graph(s) — the request must not wedge the queue.
            req = queue[0].req
            entry = self._chain_entry(req.chain) if req.chain is not None \
                else self._entry(req.graph)
        else:
            self._with_runner(entry)
        with obs.span("engine.step") as wave:
            admitted: list[tuple[_Chunk, list]] = []
            with obs.span("engine.admit"):
                while queue:
                    runs = self.slots.acquire(queue[0].n)
                    if runs is None:
                        break
                    admitted.append((queue.popleft(), runs))
            if not admitted:
                return []

            with obs.span("engine.slab") as sp:
                bits, direct = self._slab(entry.n_inputs, admitted)
                sp.note(direct=direct,
                        runs=sum(len(runs) for _, runs in admitted))
            out = entry.runners[self._exec_key](bits)

            with obs.span("engine.retire"):
                finished: list[int] = []
                n_active = sum(c.n for c, _ in admitted)
                for chunk, runs in admitted:
                    result, at = chunk.req.result, chunk.lo
                    for lo, hi in runs:
                        result[at:at + hi - lo] = out[lo:hi]
                        at += hi - lo
                    chunk.req.pending_chunks -= 1
                    self.slots.release(runs)
                    if chunk.req.pending_chunks == 0:
                        chunk.req.done = True
                        finished.append(chunk.req.uid)
                        self._retire(chunk.req.uid)
            wave.note(wave=self.invocations, samples=n_active,
                      uids=tuple(finished))
        self.invocations += 1
        self.samples_served += n_active
        self._occupancy_sum += n_active / self.capacity
        if not queue:
            del self._queues[key]
        return finished

    @property
    def idle(self) -> bool:
        return not any(self._queues.values())

    def result(self, uid: int, *, pop: bool = True) -> np.ndarray:
        """Completed request's (n_samples, n_outputs) bool outputs."""
        req = self._requests.get(uid)
        if req is None:
            raise KeyError(f"request {uid} unknown: never submitted, "
                           "already claimed, or dropped by max_retained")
        if not req.done:
            raise RuntimeError(f"request {uid} still in flight")
        if pop:
            del self._requests[uid]
            self._retained.discard(uid)
            self._compact_finished()
        return req.result

    def drain(self) -> None:
        """Run invocation waves until every queued request completes."""
        while not self.idle:
            self.step()

    def serve(self, graph: LogicGraph, bits: np.ndarray) -> np.ndarray:
        """Synchronous convenience: submit + drain + result."""
        uid = self.submit(graph, bits)
        self.drain()
        return self.result(uid)

    def serve_chain(self, graphs, bits: np.ndarray) -> np.ndarray:
        """Synchronous convenience: submit_chain + drain + result."""
        uid = self.submit_chain(graphs, bits)
        self.drain()
        return self.result(uid)

    def reset_telemetry(self) -> None:
        """Zero the invocation/occupancy counters (e.g. after warmup), so
        steady-state measurements aren't polluted by warmup waves. Program
        cache counters and slot high-water are left untouched."""
        self.invocations = 0
        self.samples_served = 0
        self._occupancy_sum = 0.0

    def stats(self) -> dict:
        inv = max(1, self.invocations)
        return {
            "capacity": self.capacity,
            "n_devices": len(self.devices),
            "sharded": self.shard,
            "invocations": self.invocations,
            "samples_served": self.samples_served,
            "mean_occupancy": self._occupancy_sum / inv,
            "slot_high_water": self.slots.high_water,
            **{f"cache_{k}": v for k, v in self.cache.stats().items()},
        }
