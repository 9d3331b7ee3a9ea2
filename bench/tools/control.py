#!/usr/bin/env python3
"""Read the comparison's two readings on the card, at a cell's own size.

From the root of a checkout, on a machine with a CUDA device:

    python3 bench/tools/control.py --workload fc1-bulk --seeds 1 2 3 \
        --seconds 10 [--fault unchanged|half|altered]

Runs the cell as the benchmark does, but with the engine's runner swapped
after set-up (``benchkit.swap``): by the TF32 control (the reference one
precision step down, in the program's place), or by one planted fault.
Prints one JSON line a seed with the numbers the run compared and whether
it came out correct.  The benchmark's own runs never swap anything; this
is how the limits in PERF.md were read.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch

    from benchkit import harness, judge, layout, swap
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = layout.resolve_cell(ROOT, args.workload)
    make = swap.control if args.fault is None else swap.FAULTS[args.fault]
    for seed in args.seeds:
        run = harness.run_cell(ROOT, cell, seed=seed, seconds=args.seconds,
                               traced=False, device=device,
                               t_process=time.perf_counter(),
                               hook=swap.runners(make))
        checks = run.checks
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "swapped_in": args.fault or "tf32 control",
                          "correct": judge.holds(checks),
                          "rows_checked": run.rows_checked,
                          **{k: v["value"] for k, v in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
