"""The comparison fails what it must: the TF32 control in the program's
place, and each fault a cell can have, planted under the timed path."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchkit import swap

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(run_wide, cell):
    """TF32's rounding flips the neurons whose sum lies near zero: a few
    of the published widths' 48,000 (fc1) neuron-pattern pairs, none of
    the tiny copy's, so this runs at the published widths (engine 256
    samples a wave), the program's own run beside it."""
    _, sound = run_wide(cell, seed=31, seconds=1.0)
    _, line = run_wide(cell, seed=31, seconds=1.0,
                       hook=swap.runners(swap.control))
    assert sound["correct"]
    assert not line["correct"]
    assert line["checks"]["bits_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(swap.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(run_tiny, cell, fault):
    _, line = run_tiny(cell, seed=41, seconds=0.5,
                       hook=swap.runners(swap.FAULTS[fault]))
    assert not line["correct"], (cell, fault, line["checks"])
