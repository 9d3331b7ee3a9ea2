"""On the card, at each cell's own size: the program's run is correct and
the TF32 control in its place is not (``pytest -m cuda bench/tests``)."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchkit import harness, judge, layout, swap
    c = layout.resolve_cell(ROOT, cell)
    dev = torch.device("cuda", 0)
    got = []
    for hook in (None, swap.runners(swap.control)):
        run = harness.run_cell(ROOT, c, seed=2**31 + 3, seconds=3.0,
                               traced=False, device=dev,
                               t_process=time.perf_counter(), hook=hook)
        got.append(judge.holds(run.checks))
    assert got == [True, False]
