"""AOT-compile logic workloads into a shared artifact store (fleet warm
start).

The port's counterpart of ``tools/precompile.py``.  Populates an
:class:`~repro_torch.core.artifact_store.ArtifactStore` directory with the
exact entries a serving process's ``ProgramCache`` would have compiled on
first contact, so a fleet of fresh ``LogicEngine`` processes
(``LogicEngine(spec, store=...)`` / ``FrontDoor(spec=..., store=...)``)
serves its first request with zero compiles.

Partition clusters compile in a process pool: a ``max_gates`` budget
splits a graph into independent output-cone clusters (core/partition.py)
whose schedules do not depend on each other, so the per-cluster
``compile_graph`` calls fan out across cores while the parent reassembles
the one :class:`CompiledArtifact` (the same bits as the serial facade).

Usage::

    PYTHONPATH=src python -m repro_torch.tools.precompile --store DIR \\
        --gates 5000 --max-gates 800 --n-unit 64 --jobs 8 --verify \\
        [--device cpu]

``--verify`` reloads every entry, checks its streams byte for byte against
a fresh compile, and runs it on ``--device`` (the mega kernel on the card
unless told otherwise) against the graph's own evaluation.  The workload
generator :func:`build_graphs` is seeded and shared with
``repro_torch.examples.warm_start``: the same ``--seed/--count/--inputs/
--gates/--outputs/--locality`` arguments name the same graphs in both.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import time
from concurrent.futures import Executor, ProcessPoolExecutor

import numpy as np

from repro_torch.core.artifact_store import ArtifactStore, store_key
from repro_torch.core.compiler import CompiledArtifact, LogicCompiler
from repro_torch.core.gate_ir import LogicGraph, random_graph
from repro_torch.core.partition import output_permutation, partition
from repro_torch.core.scheduler import LogicProgram, compile_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp.ops import mega_infer_bits, resolve_device


def build_graphs(seed: int, count: int, n_inputs: int, n_gates: int,
                 n_outputs: int, locality: int) -> list[LogicGraph]:
    """The seeded workload generator: identical arguments name identical
    graphs in every process (``examples/warm_start.py`` imports it)."""
    rng = np.random.default_rng(seed)
    return [random_graph(rng, n_inputs, n_gates, n_outputs,
                         locality=locality) for _ in range(count)]


def _compile_cluster(payload: tuple) -> tuple[dict, dict]:
    """Pool worker: schedule one (sub-)graph; returns the program payload
    (picklable arrays + scalars, not the frozen dataclass)."""
    graph, spec_dict = payload
    prog = compile_graph(graph, CompileSpec.from_dict(spec_dict))
    return prog.to_payload()


def registry_target(graph: LogicGraph, spec: CompileSpec
                    ) -> tuple[LogicGraph, CompileSpec]:
    """Mirror ``ProgramCache.get``'s keying exactly: optimize the graph
    per ``spec``, resolve ``n_unit="auto"``, fold an unbinding partition
    budget, and strip ``optimize`` (its whole effect is the post-opt
    fingerprint).  The returned pair is what the store entry is addressed
    by."""
    pipeline = spec.pipeline
    g = pipeline.run(graph).graph if pipeline is not None else graph
    spec, _ = LogicCompiler().resolve(g, spec, assume_optimized=True)
    return g, spec.normalize(g).with_(optimize="none")


def precompile_graph(store: ArtifactStore, graph: LogicGraph,
                     spec: CompileSpec, pool: Executor | None
                     ) -> tuple[str, CompiledArtifact | None, float]:
    """Compile ``(graph, spec)`` (partition clusters through ``pool`` when
    the budget binds) and publish it to ``store``.  Returns ``(key,
    artifact, seconds)``; the artifact is ``None`` when the store already
    had it."""
    g, target = registry_target(graph, spec)
    fp = g.fingerprint()
    key = store_key(fp, target)
    if store.contains(fp, target):
        if spec.pipeline is not None:   # heal a missing/stale alias
            store.save_alias(graph.fingerprint(), spec, key)
        return key, None, 0.0
    t0 = time.perf_counter()
    mono = target.with_(max_gates=None)
    if target.max_gates is not None and g.n_gates > target.max_gates:
        parts = partition(g, target)
        tasks = [(p.graph, mono.to_dict()) for p in parts]
        if pool is not None:
            payloads = list(pool.map(_compile_cluster, tasks))
        else:
            payloads = [_compile_cluster(t) for t in tasks]
        programs = tuple(LogicProgram.from_payload(a, s)
                         for a, s in payloads)
        perm = output_permutation(parts, g.n_outputs)
    else:
        task = (g, mono.to_dict())
        a, s = (pool.submit(_compile_cluster, task).result()
                if pool is not None else _compile_cluster(task))
        programs = (LogicProgram.from_payload(a, s),)
        perm = np.arange(g.n_outputs, dtype=np.int64)
    dt = time.perf_counter() - t0
    artifact = CompiledArtifact(spec=target, graph=g, programs=programs,
                                output_perm=perm, compile_s=dt)
    saved_key = store.save(artifact)
    if saved_key != key:
        raise RuntimeError(f"store key {saved_key} drifted from the "
                           f"registry target's {key}")
    if spec.pipeline is not None:
        # raw-identity alias: serving processes resolve the original
        # (unoptimized) graph straight here, skipping the pass pipeline
        store.save_alias(graph.fingerprint(), spec, key)
    return key, artifact, dt


def verify_entry(store: ArtifactStore, graph: LogicGraph,
                 spec: CompileSpec, rng: np.random.Generator,
                 device=None) -> None:
    """Reload the published entry and prove it is the right program:
    byte-identical schedule tables against a fresh compile, and the loaded
    megaprogram run on ``device`` equal to the raw graph's evaluation on
    random bits."""
    g, target = registry_target(graph, spec)
    loaded = store.load(g.fingerprint(), target)
    if loaded is None:
        raise RuntimeError("the published entry vanished")
    fresh = LogicCompiler().compile(g, target, assume_optimized=True)
    if len(loaded.programs) != len(fresh.programs):
        raise RuntimeError("program count diverged after the round-trip")
    for lp, fp_ in zip(loaded.programs, fresh.programs):
        for f in LogicProgram.ARRAY_FIELDS:
            a, b = getattr(lp, f), getattr(fp_, f)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise RuntimeError(f"stream {f} diverged after the store "
                                   "round-trip")
    bits = rng.integers(0, 2, (96, graph.n_inputs)).astype(bool)
    out = mega_infer_bits(loaded.megaprogram(), bits, device=device)
    if not (out == graph.evaluate(bits)).all():
        raise RuntimeError("the store-loaded artifact diverged from the "
                           "graph's semantics")


def parse_n_unit(v: str):
    return "auto" if v == "auto" else int(v)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", required=True, metavar="DIR",
                    help="artifact-store root directory (created if missing)")
    ap.add_argument("--device", default=None,
                    help="where --verify runs the loaded programs: CUDA "
                         "unless 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--count", type=int, default=1,
                    help="number of workload graphs")
    ap.add_argument("--inputs", type=int, default=16)
    ap.add_argument("--gates", type=int, default=800)
    ap.add_argument("--outputs", type=int, default=8)
    ap.add_argument("--locality", type=int, default=64)
    ap.add_argument("--n-unit", type=parse_n_unit, default=32,
                    metavar="N|auto")
    ap.add_argument("--alloc", choices=("direct", "liveness"),
                    default="liveness")
    ap.add_argument("--optimize", choices=("default", "none"),
                    default="default")
    ap.add_argument("--max-gates", type=int, default=None,
                    help="partition budget; clusters compile in the pool")
    ap.add_argument("--jobs", type=int, default=None,
                    help="process-pool workers (default: cpu count; "
                         "0 = in-process, no pool)")
    ap.add_argument("--verify", action="store_true",
                    help="reload every entry and assert byte + semantic "
                         "parity with a fresh compile")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    store = ArtifactStore(args.store)
    spec = CompileSpec(n_unit=args.n_unit, alloc=args.alloc,
                       optimize=args.optimize, max_gates=args.max_gates)
    graphs = build_graphs(args.seed, args.count, args.inputs, args.gates,
                          args.outputs, args.locality)
    jobs = os.cpu_count() if args.jobs is None else args.jobs
    # spawned workers: this process may hold CUDA state and threads
    pool = (ProcessPoolExecutor(max_workers=jobs,
                                mp_context=multiprocessing.get_context(
                                    "spawn")) if jobs else None)
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    try:
        for i, g in enumerate(graphs):
            key, artifact, dt = precompile_graph(store, g, spec, pool)
            if artifact is None:
                print(f"graph[{i}] {g.n_gates}g: already published "
                      f"key={key}")
            else:
                print(f"graph[{i}] {g.n_gates}g -> "
                      f"{len(artifact.programs)} program(s), "
                      f"{sum(p.n_steps for p in artifact.programs)} steps, "
                      f"{dt * 1e3:.1f} ms, key={key}")
            if args.verify:
                verify_entry(store, g, spec, rng, device=dev)
    finally:
        if pool is not None:
            pool.shutdown()
    st = store.stats()
    print(f"store {st['root']}: {st['entries']} entries "
          f"(+{st['saves']} saved) in {time.perf_counter() - t0:.2f}s"
          + (f" [verified on {dev}]" if args.verify else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
