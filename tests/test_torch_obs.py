"""The port's own spans (``repro_torch.obs``): nothing recorded while no one
listens, the wave's span tree under ``recording()`` and under a profiler,
the log's bound, and one parent stack a thread; the launch plan the
runner notes, and synthesis's span."""
import threading
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.nullanet import layer_to_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp.ops import mega_arrays
from repro_torch.serve import LogicEngine

STEP = ["engine.admit", "engine.slab", "runner", "engine.retire"]
RUNNER = ["runner.h2d", "runner.pack", "runner.kernel", "runner.unpack",
          "runner.d2h"]
CAPACITY = 32


@pytest.fixture(autouse=True)
def empty_log():
    obs.clear()
    yield
    obs.clear()


def _graph(seed, n_in=10, n_out=6):
    return random_graph(np.random.default_rng(seed), n_in, 150, n_out,
                        locality=24)


def _bits(seed, n, n_in):
    return np.random.default_rng(seed).integers(0, 2, (n, n_in)).astype(bool)


def _serve(eng, sizes, chain=False):
    """Submit requests of ``sizes`` and drain: {uid: n}."""
    g = _graph(1)
    graphs = (g, _graph(2, n_in=g.n_outputs, n_out=4))
    uids = {}
    for i, n in enumerate(sizes):
        x = _bits(10 + i, n, g.n_inputs)
        uid = eng.submit_chain(graphs, x) if chain else eng.submit(g, x)
        uids[uid] = n
    eng.drain()
    for uid in uids:
        eng.result(uid)
    return uids


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return {k: sorted(v, key=lambda s: s.start) for k, v in kids.items()}


def test_off_records_nothing_and_returns_one_object():
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=CAPACITY, device="cpu")
    _serve(eng, [CAPACITY] * 100)
    assert eng.invocations == 100
    assert obs.spans() == [] and obs.dropped() == 0
    off = obs.span("engine.step")
    assert obs.span("runner", uid=3) is off
    with off as sp:
        sp.note(wave=1)
    assert obs.spans() == []


@pytest.mark.parametrize("chain", [False, True])
def test_recording_gives_the_waves_span_tree(chain):
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=CAPACITY, device="cpu")
    _serve(eng, [5], chain=chain)                 # compile outside the log
    with obs.recording():
        uids = _serve(eng, [70, 12, 32, 9], chain=chain)
    spans = obs.spans()
    by_index = {s.index: s for s in spans}
    kids = _children(spans)
    steps = [s for s in spans if s.label == "engine.step"]
    submits = [s for s in spans if s.label == "engine.submit"]
    assert len(steps) == eng.invocations - 1 and len(submits) == len(uids)
    assert all(s.parent is None for s in steps + submits)
    for step in steps:
        assert [c.label for c in kids[step.index]] == STEP
        runner = kids[step.index][2]
        assert [c.label for c in kids[runner.index]] == RUNNER
    for s in spans:
        if s.parent is not None:
            up = by_index[s.parent]
            assert up.start <= s.start <= s.end <= up.end
        assert s.thread == threading.get_ident()
    assert [s.attrs["wave"] for s in steps] == \
        list(range(1, eng.invocations))
    assert sum(s.attrs["samples"] for s in steps) == sum(uids.values())
    # a request's uid names the wave that completed it, and only that one
    for sub in submits:
        uid = sub.attrs["uid"]
        assert sub.attrs["samples"] == uids[uid]
        done = [s for s in steps if uid in s.attrs["uids"]]
        assert len(done) == 1 and done[0].start > sub.end


def test_the_direct_path_records_every_step_span_once_a_wave():
    """Waves of one whole-capacity request hand the request's rows to the
    runner, and still record admit, slab and retire once each."""
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=CAPACITY, device="cpu")
    _serve(eng, [5])
    with obs.recording():
        _serve(eng, [CAPACITY] * 3 + [2 * CAPACITY])
    spans = obs.spans()
    steps = [s for s in spans if s.label == "engine.step"]
    assert len(steps) == 5 == eng.invocations - 1
    kids = _children(spans)
    assert all([c.label for c in kids[s.index]] == STEP for s in steps)
    counts = Counter(s.label for s in spans)
    assert all(counts[label] == 5 for label in STEP)
    slabs = [s for s in spans if s.label == "engine.slab"]
    assert all(s.attrs == {"direct": True, "runs": 1} for s in slabs)


@pytest.mark.parametrize("devices", [1, 4])
def test_split_path_keeps_only_its_runner_span(devices):
    """The split path records the runner's phases: h2d, pack, kernel and
    unpack once a shard, in shard order, then one d2h for all of them."""
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=64, shard=True,
                      devices=["cpu"] * devices)
    rows = eng.capacity // devices
    with obs.recording():
        _serve(eng, [eng.capacity - 10, 30])
    kids = _children(obs.spans())
    runners = [s for s in obs.spans() if s.label == "runner"]
    assert len(runners) == eng.invocations == 2
    for r in runners:
        assert [c.label for c in kids[r.index]] == \
            RUNNER[:-1] * devices + ["runner.d2h"]
        h2d = [c.attrs for c in kids[r.index] if c.label == "runner.h2d"]
        assert h2d == [dict(staged=False, chunks=0,
                            bytes=rows * _graph(1).n_inputs)] * devices
    steps = [s for s in obs.spans() if s.label == "engine.step"]
    assert all([c.label for c in kids[s.index]] == STEP for s in steps)


def test_a_profiler_records_the_spans_as_its_own_ranges():
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=CAPACITY, device="cpu")
    _serve(eng, [5])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, [40, 8])
    spans = Counter(s.label for s in obs.spans())
    assert spans["engine.step"] == 2 and spans["engine.submit"] == 2
    assert set(spans) == {"engine.step", "engine.submit", *STEP, *RUNNER}
    ranges = Counter(e.name for e in prof.events() if e.name in spans)
    assert ranges == spans
    _serve(eng, [8])                              # the profiler has closed
    assert Counter(s.label for s in obs.spans()) == spans


def test_the_bound_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(obs, "LIMIT", 4)
    monkeypatch.setattr(obs, "_log", obs._Log())
    with obs.recording():
        for i in range(10):
            with obs.span(f"s{i}", i=i):
                pass
    assert [s.label for s in obs.spans()] == ["s6", "s7", "s8", "s9"]
    assert [s.attrs["i"] for s in obs.spans()] == [6, 7, 8, 9]
    assert obs.dropped() == 6
    obs.clear()
    assert obs.spans() == [] and obs.dropped() == 0


def test_each_thread_keeps_its_own_parent_stack():
    both_open = threading.Barrier(2, timeout=10)
    inner_done = threading.Barrier(2, timeout=10)

    def work(name):
        with obs.span(f"{name}.outer"):
            both_open.wait()
            with obs.span(f"{name}.inner"):
                pass
            inner_done.wait()

    with obs.recording():
        threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    spans = {s.label: s for s in obs.spans()}
    assert len(spans) == 4
    for name in "ab":
        outer, inner = spans[f"{name}.outer"], spans[f"{name}.inner"]
        assert outer.parent is None and inner.parent == outer.index
        assert inner.thread == outer.thread
    assert spans["a.outer"].thread != spans["b.outer"].thread


def test_runner_kernel_notes_the_launch_plan():
    """The launch's span names the plan K2 runs: the scratch variant, the
    program's steps and rows, and the columns a block."""
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=CAPACITY, device="cpu")
    _serve(eng, [5])
    with obs.recording():
        _serve(eng, [CAPACITY, 9])
    mega = next(iter(eng.cache._entries.values())).artifact.megaprogram()
    plan = mega_arrays(mega, "cpu")["plan"]
    kernels = [s for s in obs.spans() if s.label == "runner.kernel"]
    assert len(kernels) == 2
    assert all(s.attrs == {"scratch": plan.scratch, "steps": mega.total_steps,
                           "n_addr": mega.n_addr, "cols": plan.cols}
               for s in kernels)
    assert plan.scratch == "shared"


@pytest.mark.parametrize("devices", [1, 2])
def test_runner_pack_and_unpack_note_whether_the_kernel_ran(devices):
    """On the CPU the plain pack and unpack run: each shard's
    ``runner.pack`` and ``runner.unpack`` note ``kernel=False``, and no
    pack or unpack kernel is counted."""
    from repro_torch.kernels import native
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=CAPACITY,
                      shard=devices > 1, devices=["cpu"] * devices)
    _serve(eng, [5])
    before = (native.launch_count("pack"), native.launch_count("unpack"))
    with obs.recording():
        _serve(eng, [CAPACITY, 9])
    waves = sum(s.label == "runner" for s in obs.spans())
    notes = [(s.label, s.attrs) for s in obs.spans()
             if s.label in ("runner.pack", "runner.unpack")]
    assert waves >= 1 and notes == [("runner.pack", {"kernel": False}),
                                    ("runner.unpack", {"kernel": False})] \
        * (waves * devices)
    assert (native.launch_count("pack"),
            native.launch_count("unpack")) == before


def test_runner_pack_and_unpack_note_the_launch_not_the_device(
        monkeypatch):
    """``kernel`` is read from the pack and unpack launch counts, not from
    the tensor's device: a CPU wave whose pack counts a launch notes
    ``kernel=True`` on ``runner.pack`` and still False on the unpack."""
    from repro_torch.kernels import native
    from repro_torch.kernels.logic_dsp.ref import pack_bits_ref
    from repro_torch.serve import logic_engine

    def counted_pack(x):
        native.count_launch("pack")
        return pack_bits_ref(x)

    monkeypatch.setattr(logic_engine, "pack_bits", counted_pack)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=CAPACITY,
                      devices=["cpu"])
    with obs.recording():
        _serve(eng, [CAPACITY])
    notes = [(s.label, s.attrs) for s in obs.spans()
             if s.label in ("runner.pack", "runner.unpack")]
    assert notes and notes == [("runner.pack", {"kernel": True}),
                               ("runner.unpack", {"kernel": False})] \
        * (len(notes) // 2)


def test_synthesis_records_its_span():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2, (40, 20)).astype(np.uint8)
    W = rng.standard_normal((20, 6)).astype(np.float32)
    b = (0.1 * rng.standard_normal(6)).astype(np.float32)
    layer_to_graph(x, W, b, mode="isf")
    assert obs.spans() == []
    with obs.recording():
        layer_to_graph(x, W, b, mode="isf")
    (sp,) = obs.spans()
    assert sp.label == "nullanet.layer_to_graph" and sp.parent is None
    assert {k: sp.attrs[k] for k in ("neurons", "fanin")} == \
        {"neurons": 6, "fanin": 20}
    assert 0 < sp.attrs["seconds"] <= sp.end - sp.start
