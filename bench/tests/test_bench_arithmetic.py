"""The roofline and logic_mfu arithmetic against counts made by hand."""
from __future__ import annotations

import numpy as np
import pytest

from benchkit import readers, roofline
from benchkit.trace import TraceSummary


def test_peaks_are_the_h100s():
    assert roofline.INT32_OPS_PER_S == 132 * 64 * 1.98e9
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_launch_bound_by_hand():
    # chip_smoke's LeNet-5 fc1 at capacity 8192: 36,795 gates on 256
    # words, 400 inputs and 120 outputs of 256 int32 words, 145 steps x
    # 256 lanes x 8 bytes
    shape = {"gates": 36795, "words": 256, "in_bytes": 400 * 256 * 4,
             "out_bytes": 120 * 256 * 4, "record_bytes": 145 * 256 * 8}
    ops = 36795 * 256
    nbytes = 400 * 1024 + 120 * 1024 + 145 * 2048
    bound, by = roofline.launch_bound_s(shape)
    assert by == "operations"
    assert bound == pytest.approx(ops / (132 * 64 * 1.98e9))
    assert bound > nbytes / 3.35e12
    assert bound * 1e3 == pytest.approx(0.000563, abs=2e-6)   # PERF.md K2


def test_bytes_bind_a_small_program():
    shape = {"gates": 10, "words": 256, "in_bytes": 1 << 20,
             "out_bytes": 1 << 20, "record_bytes": 0}
    bound, by = roofline.launch_bound_s(shape)
    assert by == "bytes" and bound == pytest.approx(2 ** 21 / 3.35e12)


class FakeRun:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_readers_by_hand():
    shape = {"gates": 1000, "words": 8, "in_bytes": 4096, "out_bytes": 1024,
             "record_bytes": 8192}
    tr = TraceSummary(window_s=2.0, busy_s=0.5, ops={
        "void mega_kernel<2>(...)": [4, 4e-5],
        "Memcpy HtoD (Pageable -> Device)": [4, 8e-5],
        "Memcpy DtoH (Device -> Pageable)": [4, 2e-5],
        "elementwise": [8, 1e-5]})
    run = FakeRun(shape=shape, device_trace=tr, samples=3_200_000,
                  window_s=10.0)
    assert readers.idle_share(run) == pytest.approx(75.0)
    assert readers.copy_ms(run) == pytest.approx((8e-5 + 2e-5) / 4 * 1e3)
    bound = max(1000 * 8 / roofline.INT32_OPS_PER_S,
                (4096 + 1024 + 8192) / 3.35e12)
    assert readers.k2_roofline(run) == pytest.approx(bound / 1e-5 * 100)
    # 3.2 M samples x 1000 gates / 32 = 1e8 word operations in 10 s
    assert readers.logic_mfu(run) == pytest.approx(
        1e8 / (10.0 * roofline.INT32_OPS_PER_S) * 100)


def test_idle_gaps_split_by_the_innermost_host_span():
    from benchkit.spans import Spans
    from benchkit.trace import OUTSIDE, _name_gaps
    spans = Spans()
    spans.on = True
    spans.add("engine.step", 0.0, 10.0)
    spans.add("runner", 2.0, 4.0)
    spans.add("engine.submit", 11.0, 15.0)
    got = _name_gaps([(1.0, 3.0), (9.0, 16.0)], spans)
    assert got == {"engine.step": [2, 2.0], "runner": [1, 1.0],
                   OUTSIDE: [1, 2.0], "engine.submit": [1, 4.0]}


def test_readers_find_nothing_without_a_trace():
    run = FakeRun(shape=None, device_trace=None, samples=0, window_s=None)
    for read in (readers.idle_share, readers.copy_ms, readers.k2_roofline,
                 readers.logic_mfu):
        assert read(run) is None


def test_quantile_keeps_a_missed_request_infinite():
    lat = np.r_[np.ones(90), np.full(10, np.inf)]
    assert readers.quantile(lat, 0.95) == np.inf
    assert readers.quantile(lat[:95], 0.95) == 1.0 or \
        readers.quantile(lat[:95], 0.95) == np.inf


def test_served_shape_counts_the_program(run_tiny, tiny_root):
    """Gates, words and bytes of the program a tiny cell served, against
    its graphs and its records counted by hand: one 8-byte record a lane
    and step (the shared variant), a 5-int32 row a stage, an int32 address
    for each stage's outputs (fc1's are handed on to fc2 in the kernel) and
    an int32 row for each of the last stage's."""
    from benchkit import program
    run, _ = run_tiny("stack-bulk", seconds=0.3)
    s = run.shape
    graphs = program._load_graphs(tiny_root / run.setup["cache"]
                                  / "graphs.npz")
    n_unit = 16
    assert s["gates"] == sum(g.n_gates for g in graphs)
    assert s["words"] == 256 // 32 and s["capacity"] == 256
    assert s["in_bytes"] == graphs[0].n_inputs * 8 * 4
    assert s["out_bytes"] == graphs[-1].n_outputs * 8 * 4
    assert s["record_bytes"] == (
        s["steps"] * n_unit * 8 + len(graphs) * 5 * 4
        + sum(g.n_outputs for g in graphs) * 4 + graphs[-1].n_outputs * 4)
