#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

From the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``.  The run puts
``src`` on its path, builds or loads the port's kernels (``build/``) and
the served program (``bench/.cache/``), warms up, measures for
``--seconds``, judges the served bits against the plain reference, and
prints one JSON line last: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics and the device trace with
``--trace 1``.  It needs a CUDA device; without one, or without the
port's sources beside it, it exits non-zero and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"no port beside the benchmark: {ROOT / 'src' / 'repro_torch'} "
              "is missing", file=sys.stderr)
        return 2
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "bench" / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(
        ROOT / "bench" / ".cache" / "torch_extensions")
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    from benchkit import harness
    return harness.main(args, ROOT, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
