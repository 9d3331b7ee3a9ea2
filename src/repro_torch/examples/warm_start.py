"""Fleet warm start: a fresh engine process serves its first request
with zero compiles by loading compiled artifacts from a shared store.

The port's counterpart of ``examples/warm_start.py``, on ``--device`` (the
mega kernel on the card unless told otherwise).  Two-process flow::

    PYTHONPATH=src python -m repro_torch.tools.precompile \
        --store /tmp/logic-store
    PYTHONPATH=src python -m repro_torch.examples.warm_start \
        --store /tmp/logic-store [--device cpu]

The second command builds the *same* seeded workload (it imports the
precompile tool's ``build_graphs``: identical arguments name identical
graphs), boots a brand-new :class:`~repro_torch.serve.LogicEngine` pointed
at the store, serves every graph bit-exactly, and asserts **compiles == 0**
via the cache counters — proof the fleet warm-started from disk rather
than re-deriving the schedules.

Run without ``--store`` for a self-contained demo: phase one plays the
cold node (compile + write-through), phase two plays the warm node
(store hit), with the cold/warm timings printed side by side.
"""
import argparse
import sys
import tempfile
import time

import numpy as np

from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.spec import CompileSpec
from repro_torch.serve import ArtifactStore, LogicEngine
from repro_torch.tools.precompile import build_graphs, parse_n_unit


def serve_all(engine: LogicEngine, graphs: list[LogicGraph],
              rng: np.random.Generator) -> float:
    t0 = time.perf_counter()
    for g in graphs:
        bits = rng.integers(0, 2, (64, g.n_inputs)).astype(bool)
        out = engine.serve(g, bits)
        assert (out == g.evaluate(bits)).all(), "served wrong bits"
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", metavar="DIR", default=None,
                    help="store populated by repro_torch.tools.precompile; "
                         "omitted = self-contained two-phase demo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--count", type=int, default=1)
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
    ap.add_argument("--max-gates", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="where the engines run: CUDA unless 'cpu'")
    args = ap.parse_args(argv)

    spec = CompileSpec(n_unit=args.n_unit, alloc=args.alloc,
                       optimize=args.optimize, max_gates=args.max_gates)
    graphs = build_graphs(args.seed, args.count, args.inputs, args.gates,
                          args.outputs, args.locality)
    rng = np.random.default_rng(args.seed + 2)

    tmp = None
    if args.store is None:
        tmp = tempfile.TemporaryDirectory(prefix="warm-start-")
        store = ArtifactStore(tmp.name)
        # Phase 1 — the cold node: compiles, then writes through to the
        # shared store so the rest of the fleet never has to.
        cold = LogicEngine(spec, capacity=128, store=store,
                           device=args.device)
        cold_s = serve_all(cold, graphs, np.random.default_rng(args.seed + 2))
        cs = cold.cache.stats()
        assert cs["compiles"] == len(graphs) and \
            cs["store_saves"] == len(graphs)
        print(f"cold node: {cs['compiles']} compiles, "
              f"{cs['store_saves']} artifacts published, "
              f"{cold_s * 1e3:.1f} ms  [bit-exact]")
    else:
        store = ArtifactStore(args.store)
        cold_s = None
        if store.stats()["entries"] == 0:
            print(f"store {args.store} is empty — run the precompile tool "
                  f"with the same workload arguments first", file=sys.stderr)
            return 1

    # Phase 2 — the warm node: a brand-new engine (fresh process when
    # --store is used) whose first request must not compile anything.
    warm = LogicEngine(spec, capacity=128, store=store, device=args.device)
    warm_s = serve_all(warm, graphs, rng)
    ws = warm.cache.stats()
    assert ws["compiles"] == 0, f"warm node compiled: {ws}"
    assert ws["store_hits"] == len(graphs), f"expected all store hits: {ws}"
    speed = f" ({cold_s / warm_s:.1f}x vs cold)" if cold_s else ""
    print(f"warm node: 0 compiles, {ws['store_hits']} store hits, "
          f"{warm_s * 1e3:.1f} ms{speed}  [bit-exact]")
    print("warm-start OK:", {k: ws[k] for k in
                             ("compiles", "store_hits", "store_misses",
                              "store_failures")})
    if tmp is not None:
        tmp.cleanup()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
