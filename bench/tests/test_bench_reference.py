"""The reference agrees with the port's served bits (CPU, small size)."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchkit.inputs import make_layers
from reference.binarized import binarize, pattern_table, stack

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(run_tiny, cell):
    run, line = run_tiny(cell, seed=2**31 + 11, seconds=1.0)
    assert line["correct"], line["checks"]
    assert line["checks"]["bits_wrong"]["value"] == 0
    assert line["checks"]["requests_checked"]["value"] > 0
    assert run.attempted > 0 and run.failed == 0
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_per_layer_metrics(run_tiny, cell):
    run, line = run_tiny(cell, seed=12, seconds=1.0, traced=True)
    assert line["correct"]
    got = set(line["metrics"])
    assert "first_request_ms.setup" in got
    assert {"engine_host_ms.bulk", "gc_ms.bulk", "runner_ms.bulk"} <= got
    # no device here: the device's metrics find nothing and are left out
    assert not any("idle" in m or "roofline" in m for m in got)
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_synthesized_program_is_exact_on_its_patterns(tiny_root):
    """The fact the reference rests on: the program equals the binarized
    stack on the first layer's patterns, evaluated by the port's own
    netlist oracle."""
    from benchkit import program
    cfg = json.loads((tiny_root / "bench/configs/lenet5-hidden.json")
                     .read_text())
    layers = make_layers(cfg)
    where = program.cache_dir(tiny_root, "lenet5-hidden",
                              tiny_root / "bench/configs/lenet5-hidden.json")
    graphs, _ = program.graphs(layers, where)
    h = layers[0].patterns.astype(bool)
    for g in graphs:
        h = g.evaluate(h)
    assert np.array_equal(h, pattern_table(layers))
    assert np.array_equal(stack(layers[0].patterns, layers),
                          pattern_table(layers, rows=7))


def test_float64_sums_of_float32_terms_do_not_depend_on_order():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((400, 120), dtype=np.float32)
    b = rng.standard_normal(120, dtype=np.float32)
    x = rng.integers(0, 2, (64, 400), dtype=np.uint8)
    pm = (2.0 * x - 1.0)
    rev = (pm[:, ::-1] @ W[::-1].astype(np.float64) + b) >= 0
    assert np.array_equal(binarize(x, W, b), rev.astype(np.uint8))
