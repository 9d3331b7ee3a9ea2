"""Serving front door demo: two tenants, deadlines, faults, traffic.

The port's counterpart of ``examples/serve_frontdoor.py``, on ``--device``
(the mega kernel on the card unless told otherwise).  Stands up a
:class:`~repro_torch.serve.FrontDoor` over one shared
``LogicEngine``/``ProgramCache``, registers two tenant models, warms
the compile/jit caches, then drives a Poisson + heavy-tail (Pareto)
closed-loop trace with fault injection on (eviction storm + injected
dispatch delay) and prints the degradation report: p50/p99 latency,
goodput, shed rate by machine-readable reason, deadline-miss rate.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_frontdoor
          [--quick] [--device cpu]
"""
import argparse
import asyncio
import json

import numpy as np

from repro_torch.core.gate_ir import random_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.serve import (FaultPolicy, FrontDoor, Priority,
                               TrafficPattern, build_trace, run_trace)


async def main(quick: bool, device=None) -> None:
    rng = np.random.default_rng(0)
    graph_a = random_graph(rng, 16, 300 if quick else 800, 10, locality=64)
    graph_b = random_graph(rng, 12, 200 if quick else 500, 8, locality=64)

    door = FrontDoor(spec=CompileSpec(n_unit=32), capacity=128,
                     max_queue=24, default_deadline_s=0.5,
                     fault_policy=FaultPolicy(seed=7, evict_rate=0.05,
                                              delay_rate=0.05,
                                              delay_s=0.003),
                     device=device)
    door.register("vision", graph_a, max_inflight=8)
    door.register("ranking", graph_b, max_inflight=8)

    async with door:
        # warm the compile caches AND the wave-time window (the
        # admission controller's service estimate) so the trace
        # measures serving, not cold starts
        for _ in range(5):
            for name, g in (("vision", graph_a), ("ranking", graph_b)):
                bits = rng.integers(0, 2, (48, g.n_inputs)).astype(bool)
                out = await door.submit(name, bits, deadline_s=30.0)
                assert (out == g.evaluate(bits)).all()
        door.reset_metrics()

        n = 60 if quick else 200
        trace = build_trace([
            TrafficPattern(tenant="vision", rate_rps=150.0, n_requests=n,
                           size_mean=40, deadline_s=0.25,
                           priority_mix=((Priority.HIGH, 0.2),
                                         (Priority.NORMAL, 0.8))),
            TrafficPattern(tenant="ranking", rate_rps=100.0, n_requests=n,
                           arrival="pareto", pareto_alpha=1.4,
                           size_mean=24, deadline_s=0.25,
                           priority_mix=((Priority.NORMAL, 0.5),
                                         (Priority.BATCH, 0.5))),
        ], seed=11)
        report = await run_trace(door, trace, seed=13)

    print(json.dumps(report.to_dict(), indent=2))
    m = door.metrics()
    print(f"door: retries={m['retries']} faults={m['faults_injected']} "
          f"wave_est_ms={m['wave_est_ms']:.2f}")
    assert report.completed + report.shed == report.offered, \
        "every offered request must resolve (complete or shed) — no hangs"
    print("ok: every request resolved (no hangs)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the door's engine runs: CUDA unless 'cpu'")
    args = ap.parse_args()
    asyncio.run(main(args.quick, args.device))
