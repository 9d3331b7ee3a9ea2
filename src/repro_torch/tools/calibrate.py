"""Fit and persist the wall-clock phase calibration on one device.

The port's counterpart of ``tools/calibrate.py``.  Measures the seeded
workload x ``n_unit`` probe grid on ``--device``
(``core.calibrate.collect_probes``: each probe compiles one graph and times
the pack/setup/kernel/unpack path of ``ops.phased_infer_bits``, each phase
fenced by ``torch.cuda.synchronize`` on the card), least-squares fits the
per-phase factors, and publishes the fit to an
:class:`~repro_torch.core.artifact_store.ArtifactStore` under the device's
calibration record (``torch-cuda`` or ``torch-cpu``,
``ops.calibration_name``): the fit that a ``ProgramCache`` of engines on
that device picks up for ``CompileSpec(n_unit="auto",
objective="wallclock")``.

Usage::

    PYTHONPATH=src python -m repro_torch.tools.calibrate --store DIR \\
        --quick --verify [--device cpu]

``--verify`` spawns a fresh Python process that loads the record back
through the store, and through a ``ProgramCache`` on the same device, and
asserts ``calibrate.fit_count() == 0``: a warm process resolves wallclock
specs with zero re-fits.  A calibration is specific to its host and card:
run this again after moving a store to another machine.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.core import calibrate
from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.kernels.logic_dsp.ops import calibration_name, resolve_device

SRC = Path(__file__).resolve().parents[2]

#: The --verify child: load from the store in a fresh interpreter, prove
#: the load path never re-fits, and resolve a wallclock auto spec with it.
_VERIFY_SNIPPET = """
import sys
import numpy as np
from repro_torch.core import calibrate
from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.compiler import LogicCompiler
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.serve import ProgramCache

store_root, name, device = sys.argv[1], sys.argv[2], sys.argv[3]
store = ArtifactStore(store_root)
cal = store.load_calibration(name)
if cal is None:
    sys.exit("persisted calibration record not found")
cache = ProgramCache(store=store, device=device)
if cache.compiler.calibration is None:
    sys.exit(f"a ProgramCache on {device} did not load {name!r}")
compiler = LogicCompiler(calibration=cal)
g = random_graph(np.random.default_rng(7), 16, 400, 8, locality=64)
spec, search = compiler.resolve(
    g, CompileSpec(n_unit="auto", objective="wallclock"))
if not (spec.resolved and search.objective == "wallclock"
        and search.alt is not None and search.alt.objective == "cycles"):
    sys.exit(f"wallclock resolution failed: {spec} {search}")
if calibrate.fit_count() != 0:
    sys.exit(f"loading and resolving re-fitted "
             f"(fit_count={calibrate.fit_count()})")
print(f"verify: wallclock pick n_unit={spec.n_unit} "
      f"(cycles pick {search.alt.best_n_unit}), zero re-fits")
"""


def verify(store_root, name: str, device: str
           ) -> subprocess.CompletedProcess:
    """Load the record ``name`` back in a fresh Python process (the
    ``--verify`` check); a return code of 0 means it loaded, served a
    wallclock resolution and re-fitted nothing."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-c", _VERIFY_SNIPPET, str(store_root), name,
         device], env=env, capture_output=True, text=True, timeout=600)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", required=True, metavar="DIR",
                    help="artifact-store root directory (created if "
                         "missing)")
    ap.add_argument("--device", default=None,
                    help="device to fit on: CUDA unless 'cpu'")
    grid = ap.add_mutually_exclusive_group()
    grid.add_argument("--quick", action="store_true", default=True,
                      help="3-workload x 5-unit probe grid (default)")
    grid.add_argument("--full", dest="quick", action="store_false",
                      help="5-workload x 6-unit probe grid")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per probe, min taken "
                         "(default: %(default)s)")
    ap.add_argument("--batch", type=int, default=1024,
                    help="input vectors per probe (default: %(default)s)")
    ap.add_argument("--verify", action="store_true",
                    help="fresh-process load smoke: the persisted record "
                         "must serve wallclock resolution with ZERO "
                         "re-fits (fit_count() == 0)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = calibration_name(dev)
    store = ArtifactStore(args.store)
    graphs = calibrate.default_probe_graphs(quick=args.quick)
    units = calibrate.default_probe_units(quick=args.quick)
    print(f"probing {len(graphs)} workloads x {len(units)} unit counts on "
          f"{dev} (reps={args.reps}, batch={args.batch})...")
    t0 = time.perf_counter()
    probes = calibrate.collect_probes(graphs, units,
                                      n_input_vectors=args.batch,
                                      reps=args.reps, device=dev)
    cal = calibrate.fit_calibration(probes, meta={
        "grid": "quick" if args.quick else "full", "device": str(dev),
        "reps": args.reps, "batch": args.batch, "n_probes": len(probes)})
    for phase in calibrate.PHASES:
        f = cal.fits[phase]
        coefs = ", ".join(f"{c:.3e}" for c in f.coefs)
        print(f"  {phase:7s} coefs=[{coefs}] offset={f.offset * 1e6:8.1f}us"
              f"  median |err| {f.median_abs_rel_err * 100:5.1f}%")
    path = store.save_calibration(cal, name=name)
    print(f"fitted {len(probes)} probes in {time.perf_counter() - t0:.1f}s; "
          f"worst-phase median error "
          f"{cal.median_abs_rel_err() * 100:.1f}%; saved -> {path}")

    if args.verify:
        proc = verify(args.store, name, dev.type)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            print("verify FAILED", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
