"""The program's own spans in a run of the tiny copy: a traced run reads
the eight metrics of the step's and the runner's phases, every program
span lies inside the harness's span around the same call (one clock), and
an untraced run records none."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchkit import program_spans

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
PHASES = {"admit_ms.bulk", "slab_ms.bulk", "retire_ms.bulk",
          "h2d_host_ms.bulk", "pack_ms.bulk", "kernel_launch_ms.bulk",
          "unpack_ms.bulk", "d2h_wait_ms.bulk"}


def _inside(spans, harness: np.ndarray) -> bool:
    """Every span lies within one of the harness's intervals."""
    starts = harness[:, 0]
    for s in spans:
        i = np.searchsorted(starts, s.start, side="right") - 1
        if i < 0 or not harness[i, 0] <= s.start <= s.end <= harness[i, 1]:
            return False
    return True


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_phases_on_the_harness_clock(run_tiny, cell):
    run, line = run_tiny(cell, seed=2**31 + 29, seconds=1.0, traced=True)
    assert line["correct"]
    got = line["metrics"]
    assert PHASES <= set(got)
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms"
               for m in PHASES)
    spans = program_spans.in_window(run)
    steps = [s for s in spans if s.label == "engine.step"]
    runners = [s for s in spans if s.label == "runner"]
    assert steps and len(runners) == len(steps)
    assert _inside(steps, run.spans.intervals("engine.step"))
    assert _inside(runners, run.spans.intervals("runner"))
    # the step's phases lie within it: their mean is less than the step's
    step_ms = program_spans.per_wave_ms(run, "engine.step")
    assert sum(got[m]["value"] for m in ("admit_ms.bulk", "slab_ms.bulk",
                                         "retire_ms.bulk")) < step_ms


def test_untraced_run_records_no_program_span(run_tiny):
    from repro_torch import obs
    obs.clear()
    run, line = run_tiny("fc1-bulk", seed=2**31 + 30, seconds=0.3)
    assert line["correct"] and run.samples > 0
    assert obs.spans() == []
    assert not PHASES & set(line["metrics"])
