"""The generators are deterministic in their seeds."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from benchkit import traffic
from benchkit.inputs import make_layers

ROOT = Path(__file__).resolve().parents[2]


def test_pool_and_offsets_are_deterministic():
    p1 = traffic.pattern_pool(400, 1000, 123)
    assert np.array_equal(p1, traffic.pattern_pool(400, 1000, 123))
    assert not np.array_equal(p1, traffic.pattern_pool(400, 1000, 124))
    n = traffic.sizes(24, 256, 500, np.random.default_rng(3))
    assert n.max() <= 256 and n.min() >= 1
    o = traffic.offsets(1000, n, np.random.default_rng(3))
    assert np.all(o + n <= 1000) and np.all(o >= 0)
    assert np.array_equal(o, traffic.offsets(1000, n,
                                             np.random.default_rng(3)))


def test_layers_are_deterministic_in_the_program_seed():
    cfg = json.loads((ROOT / "bench/configs/lenet5-hidden.json").read_text())
    a, b = make_layers(cfg), make_layers(cfg)
    for x, y in zip(a, b):
        assert np.array_equal(x.W, y.W) and np.array_equal(x.patterns,
                                                           y.patterns)
    assert a[0].W.dtype == np.float32 and a[0].W.shape == (400, 120)
    assert a[1].patterns.shape == (400, 120)
    one = make_layers(json.loads(
        (ROOT / "bench/configs/lenet5-fc1.json").read_text()))
    assert np.array_equal(one[0].W, a[0].W)     # fc1 is the same layer


def test_closed_feed_is_deterministic(run_tiny):
    seen = []

    def hook(engine, ctx):
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "closed_for_test", ctx.root / "bench/drivers/closed.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        feed = mod.Feed(ctx, ctx.mix)
        seen.append([feed.next() for _ in range(50)])

    run_tiny("fc1-bulk", seed=77, seconds=0.2, hook=hook)
    run_tiny("fc1-bulk", seed=77, seconds=0.2, hook=hook)
    run_tiny("fc1-bulk", seed=78, seconds=0.2, hook=hook)
    assert seen[0] == seen[1] != seen[2]
