"""Statically verify compiled artifacts in an artifact store (CLI front
end of core/verify.py; DESIGN.md §13).

The port's counterpart of ``tools/verify_program.py``, over the port's
:class:`~repro_torch.core.artifact_store.ArtifactStore` and its copy of
the schedule verifier.  Store checksums prove the *bytes* of an entry
round-tripped; this tool proves the *schedules* still compute their
recorded graphs — def-before-use on every scratch row, trash-row
isolation, megakernel stage-handoff soundness, permutation bijectivity,
and the full dataflow-term comparison against each entry's
post-optimization graph.  Run it against a fleet's shared store after a
toolchain upgrade, before promoting a warm-start directory, or in CI
against freshly precompiled entries::

    PYTHONPATH=src python -m repro_torch.tools.verify_program --store S
    PYTHONPATH=src python -m repro_torch.tools.verify_program --store S \\
        KEY1 KEY2
    PYTHONPATH=src python -m repro_torch.tools.verify_program --store S \\
        --json

Exit status: 0 when every selected entry verifies clean, 1 when any
entry fails (the failure summaries name exact rule codes and
``(stage, step, lane, addr)`` locations), 2 on usage errors (unknown
key, empty store with explicit keys).  Verification failures do NOT
quarantine here — this is an inspection tool; pass ``--quarantine`` to
opt into moving failed entries out of the serving namespace the way a
``verify="load"`` server would.  The check is static: it runs no kernel
and needs no device.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.errors import ArtifactIntegrityError
from repro_torch.core.verify import verify_artifact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="statically verify compiled artifacts in a store")
    ap.add_argument("--store", required=True,
                    help="artifact store root directory")
    ap.add_argument("keys", nargs="*",
                    help="store keys to verify (default: every entry)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object per entry instead of text")
    ap.add_argument("--quarantine", action="store_true",
                    help="quarantine entries that fail verification")
    ap.add_argument("--max-diagnostics", type=int, default=16,
                    help="diagnostic cap per entry (default 16)")
    args = ap.parse_args(argv)

    store = ArtifactStore(args.store)
    keys = args.keys or store.keys()
    if args.keys:
        unknown = [k for k in args.keys if k not in store]
        if unknown:
            print(f"error: no store entry for {unknown}", file=sys.stderr)
            return 2
    if not keys:
        print(f"{args.store}: no entries", file=sys.stderr)
        return 0

    failed = 0
    for key in keys:
        try:
            artifact = store.load_key(key)
        except ArtifactIntegrityError as exc:
            # integrity failures quarantine at the store layer already
            failed += 1
            rec = {"key": key, "ok": False, "error": str(exc)}
            print(json.dumps(rec) if args.json
                  else f"FAIL {key}: {exc}")
            continue
        report = verify_artifact(artifact,
                                 max_diagnostics=args.max_diagnostics)
        if args.json:
            print(json.dumps({
                "key": key, "ok": report.ok, "name": artifact.graph.name,
                "n_programs": len(artifact.programs),
                "elapsed_s": report.elapsed_s,
                "checked": report.checked,
                "diagnostics": [str(d) for d in report.diagnostics]}))
        else:
            print(("OK   " if report.ok else "FAIL ") + key + ": "
                  + report.summary())
        if not report.ok:
            failed += 1
            if args.quarantine:
                qpath = store.quarantine(key)
                if not args.json:
                    print(f"     quarantined -> {qpath}")
    if not args.json:
        print(f"{len(keys)} entr{'y' if len(keys) == 1 else 'ies'}, "
              f"{failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
