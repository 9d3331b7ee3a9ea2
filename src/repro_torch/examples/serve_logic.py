"""Serving demo: continuous-batched inference over compiled logic programs.

    PYTHONPATH=src python -m repro_torch.examples.serve_logic [--device cpu]

The port's counterpart of ``examples/serve_logic.py``, on ``--device``
(the mega kernel on the card unless told otherwise).  Spins up a
:class:`~repro_torch.serve.LogicEngine` and serves mixed traffic the
way a production front-end would (ROADMAP north star; paper §5.2.4):

  1. ragged bit-vector requests for one FFCL, slot-packed into single
     fabric invocations (32 samples/word x W words, core/packing.py);
  2. repeat traffic for a structurally identical graph — program-cache hit,
     no recompile;
  3. a graph over the partition budget, served as a pipelined sequence of
     sub-programs (core/partition.py) with word-level re-assembly;
  4. one full wave under ``obs.recording()``: its phases from the engine's
     own spans (a ``torch.profiler`` trace shows the same ranges above
     their kernels).

Every response is checked bit-exact against direct DAG evaluation.
"""
import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.serve import LogicEngine


def main(device=None) -> None:
    rng = np.random.default_rng(0)
    engine = LogicEngine(CompileSpec(n_unit=64), capacity=256, device=device)
    print(f"engine: capacity={engine.capacity} samples/invocation, "
          f"n_unit={engine.n_unit}, device={engine.device}")

    # -- 1. ragged traffic for one graph ------------------------------------
    g = random_graph(rng, 32, 1500, 16, locality=128)
    sizes = [97, 33, 64, 5, 180, 41, 12, 70]
    reqs = [(n, rng.integers(0, 2, (n, 32)).astype(bool)) for n in sizes]
    uids = [engine.submit(g, bits) for _, bits in reqs]
    t0 = time.perf_counter()
    engine.drain()
    dt = time.perf_counter() - t0
    for uid, (_, bits) in zip(uids, reqs):
        assert (engine.result(uid) == g.evaluate(bits)).all()
    n = sum(sizes)
    print(f"served {len(sizes)} ragged requests ({n} samples) in "
          f"{engine.invocations} invocations, {dt * 1e3:.1f} ms "
          f"({n / dt:.0f} samples/s)  [bit-exact]")

    # -- 2. repeat traffic: program-cache hit -------------------------------
    g_again = g.copy()
    g_again.name = "resubmitted-by-another-worker"
    x = rng.integers(0, 2, (50, 32)).astype(bool)
    t0 = time.perf_counter()
    out = engine.serve(g_again, x)
    assert (out == g.evaluate(x)).all()
    print(f"structural-copy request: cache hit, no recompile "
          f"({(time.perf_counter() - t0) * 1e3:.1f} ms; "
          f"hits={engine.cache.hits} misses={engine.cache.misses})")

    # -- 3. partitioned pipeline for an over-budget graph -------------------
    part_engine = LogicEngine(CompileSpec(n_unit=64, max_gates=600),
                              capacity=256, cache=engine.cache,
                              device=engine.device)
    big = random_graph(rng, 24, 2000, 24, locality=96)
    x = rng.integers(0, 2, (130, 24)).astype(bool)
    out = part_engine.serve(big, x)
    assert (out == big.evaluate(x)).all()
    # keyed on the POST-optimization fingerprint: fetch with the engine's
    # spec to get the entry it actually served
    entry = part_engine.cache.get(big, part_engine.spec)
    print(f"over-budget graph ({big.n_gates} gates) served as "
          f"{len(entry.programs)} pipelined sub-programs  [bit-exact]")

    # -- 4. one wave's split, from the engine's own spans -------------------
    x = rng.integers(0, 2, (engine.capacity, 32)).astype(bool)
    obs.clear()
    with obs.recording():
        out = engine.serve(g, x)
    assert (out == g.evaluate(x)).all()
    print("one full wave, by the engine's spans:")
    depth = {None: -1}
    for sp in sorted(obs.spans(), key=lambda sp: sp.start):
        depth[sp.index] = depth[sp.parent] + 1
        print(f"  {'  ' * depth[sp.index]}{sp.label:<14} "
              f"{(sp.end - sp.start) * 1e3:7.3f} ms")

    print("stats:", engine.stats())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the engine runs: CUDA unless 'cpu'")
    main(ap.parse_args().device)
