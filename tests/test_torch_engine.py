"""The port's LogicEngine against the reference's, on the CPU, bit-exact.

``repro_torch``'s ``LogicEngine(device="cpu")`` and ``repro``'s
``LogicEngine(interpret=True)`` serve the same ragged requests on the same
seeded graphs; outputs, ``stats()`` and cache behaviour must agree.  The
carry-across tests feed the port a reference artifact and reference MLP
parameters through ``repro_torch.convert``.
"""
import time

import numpy as np
import pytest
import torch

from repro.core.compiler import LogicCompiler as RefCompiler
from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.nullanet import BinaryMLPConfig, init_binary_mlp
from repro.core.nullanet import layer_to_graph as ref_layer_to_graph
from repro.core.spec import CompileSpec as RefSpec
from repro.serve import LogicEngine as RefEngine
from repro_torch import obs
from repro_torch.convert import (artifact_from_reference,
                                 params_from_reference,
                                 program_from_reference)
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.nullanet import layer_to_graph
from repro_torch.core.scheduler import execute_program_np
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp.ops import logic_infer_bits, mega_infer_bits
from repro_torch.serve import LogicEngine, ProgramCache, SlotTable
from repro_torch.serve.logic_engine import (STAGE_CHUNK_BYTES, RowRuns,
                                            stage_rows)

SIZES = [1, 33, 70, 5, 64, 130]          # ragged; 130 spans three waves


def _graphs(seed, n_in=10, n_gates=240, n_out=7):
    kw = dict(locality=32)
    return (ref_random_graph(np.random.default_rng(seed), n_in, n_gates,
                             n_out, **kw),
            random_graph(np.random.default_rng(seed), n_in, n_gates, n_out,
                         **kw))


def _requests(seed, n_in, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, (n, n_in)).astype(bool) for n in sizes]


def _serve_all(eng, graph, reqs):
    uids = [eng.submit(graph, x) for x in reqs]
    eng.drain()
    return [eng.result(u) for u in uids]


def _count_runner_calls(eng, graph):
    """Wrap the engine's runner for ``graph`` so each wave is counted."""
    entry = eng._entry(graph)
    run = entry.runners[eng._exec_key]
    calls = []

    def counted(bits):
        calls.append(bits.shape)
        return run(bits)

    entry.runners[eng._exec_key] = counted
    return calls


def _keep_runner_args(eng, entry):
    """Wrap ``entry``'s runner so each wave's slab is kept as it came."""
    run = entry.runners[eng._exec_key]
    slabs = []

    def kept(bits):
        slabs.append(bits)
        return run(bits)

    entry.runners[eng._exec_key] = kept
    return slabs


def _slab_notes():
    return [(s.attrs["direct"], s.attrs["runs"]) for s in obs.spans()
            if s.label == "engine.slab"]


@pytest.mark.parametrize("spec_kw", [dict(n_unit=16),
                                     dict(n_unit=16, max_gates=80),
                                     dict(n_unit=8, alloc="direct",
                                          optimize="none")],
                         ids=["monolithic", "partitioned", "direct_raw"])
def test_engine_matches_reference_engine(spec_kw):
    ref_g, g = _graphs(1)
    reqs = _requests(2, g.n_inputs)
    ref = RefEngine(RefSpec(**spec_kw), capacity=96, interpret=True)
    eng = LogicEngine(CompileSpec(**spec_kw), capacity=96, device="cpu")
    calls = _count_runner_calls(eng, g)
    ref._entry(ref_g)                    # the same cache lookup, for stats
    want = _serve_all(ref, ref_g, reqs)
    got = _serve_all(eng, g, reqs)
    for x, w, o in zip(reqs, want, got):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, g.evaluate(x))
    if "max_gates" in spec_kw:
        assert eng.cache.peek(next(iter(eng.cache._entries))).partitioned
    assert eng.stats() == ref.stats()
    # one runner call (one mega-kernel launch on the card) per wave
    assert len(calls) == eng.stats()["invocations"] >= 3
    assert all(shape == (96, g.n_inputs) for shape in calls)


def test_engine_stats_schema_matches_reference():
    ref = RefEngine(RefSpec(n_unit=8), capacity=64, interpret=True)
    eng = LogicEngine(CompileSpec(n_unit=8), capacity=64, device="cpu")
    assert eng.stats().keys() == ref.stats().keys()
    assert (eng.stats()["n_devices"], eng.stats()["sharded"]) == (1, False)


def test_serve_chain_matches_reference():
    pairs = [_graphs(10 + k, n_in, 120, n_out)
             for k, (n_in, n_out) in enumerate([(8, 6), (6, 5), (5, 4)])]
    x = _requests(3, 8, [150])[0]
    ref = RefEngine(RefSpec(n_unit=8), capacity=64, interpret=True)
    eng = LogicEngine(CompileSpec(n_unit=8), capacity=64, device="cpu")
    want = ref.serve_chain([r for r, _ in pairs], x)
    got = eng.serve_chain([p for _, p in pairs], x)
    np.testing.assert_array_equal(got, want)
    misses = eng.cache.misses
    np.testing.assert_array_equal(
        eng.serve_chain([p for _, p in pairs], x), want)
    assert eng.cache.misses == misses and eng.cache.hits >= 1
    ref.serve_chain([r for r, _ in pairs], x)
    assert eng.stats() == ref.stats()


# ---------------------------------------------------------------------------
# rows held as runs: the direct slab, the slab by runs, retire by runs
# ---------------------------------------------------------------------------

def test_full_capacity_request_takes_the_direct_path():
    ref_g, g = _graphs(20)
    x = _requests(21, g.n_inputs, [2 * 96])[0]
    ref = RefEngine(RefSpec(n_unit=16), capacity=96, interpret=True)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=96, device="cpu")
    slabs = _keep_runner_args(eng, eng._entry(g))
    ref._entry(ref_g)                    # the same cache lookup, for stats
    want = ref.serve(ref_g, x)
    obs.clear()
    with obs.recording():
        got = eng.serve(g, x)
    notes = _slab_notes()
    obs.clear()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, g.evaluate(x))
    assert eng.stats() == ref.stats()
    # two waves, each the request's own rows handed to the runner
    assert notes == [(True, 1), (True, 1)] and len(slabs) == 2
    for i, bits in enumerate(slabs):
        assert bits.shape == (96, g.n_inputs)
        assert np.shares_memory(bits, x)
        np.testing.assert_array_equal(bits, x[96 * i:96 * (i + 1)])
    assert eng.slots.n_free == 96


def _read_only(x):
    x = x.copy()
    x.setflags(write=False)
    return x


@pytest.mark.parametrize("layout", [
    _read_only, np.asfortranarray,
    lambda x: np.concatenate([x, x], axis=1)[:, :x.shape[1]]],
    ids=["read_only", "fortran", "column_view"])
def test_inputs_that_cannot_be_handed_over_take_the_slab(layout):
    ref_g, g = _graphs(22)
    x = _requests(23, g.n_inputs, [96])[0]
    held = layout(x)
    assert not (held.flags.c_contiguous and held.flags.writeable)
    ref = RefEngine(RefSpec(n_unit=16), capacity=96, interpret=True)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=96, device="cpu")
    slabs = _keep_runner_args(eng, eng._entry(g))
    ref._entry(ref_g)
    want = ref.serve(ref_g, x)
    obs.clear()
    with obs.recording():
        got = eng.serve(g, held)
    notes = _slab_notes()
    obs.clear()
    assert notes == [(False, 1)] and len(slabs) == 1
    assert not np.shares_memory(slabs[0], held)
    assert slabs[0].flags.c_contiguous and slabs[0].flags.writeable
    np.testing.assert_array_equal(slabs[0], x)       # the same bits
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, g.evaluate(x))
    assert eng.stats() == ref.stats()


def test_ragged_requests_over_fragmented_rows():
    """Rows held outside the engine fragment its free rows: chunks then
    take several runs, the rows around them stay zero, and once the held
    rows come back a request spanning waves completes as the reference's
    does."""
    ref_g, g = _graphs(24)
    reqs = _requests(25, g.n_inputs, [33, 1, 70, 5, 130, 64, 17])
    ref = RefEngine(RefSpec(n_unit=16), capacity=96, interpret=True)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=96, device="cpu")
    slabs = _keep_runner_args(eng, eng._entry(g))
    ref._entry(ref_g)
    holds = {}
    for e in (ref, eng):
        taken = [e.slots.acquire(k) for k in (7, 13, 5, 20)]
        e.slots.release(taken[1])
        e.slots.release(taken[3])
        holds[e] = (taken[0], taken[2])
    assert eng.slots._free == [(7, 20), (25, 96)]
    acquired = []
    acquire = eng.slots.acquire
    eng.slots.acquire = lambda n: acquired.append(acquire(n)) or acquired[-1]
    uids = {e: [e.submit(gr, x) for x in reqs]
            for e, gr in ((ref, ref_g), (eng, g))}
    for e in (ref, eng):            # the 96-row chunk waits at the head
        while e.step():
            pass
        assert not e.idle
        if e is eng:
            fragmented = list(slabs)
        for rows in holds[e]:
            e.slots.release(rows)
        e.drain()
    want = [ref.result(u) for u in uids[ref]]
    got = [eng.result(u) for u in uids[eng]]
    for x, w, o in zip(reqs, want, got):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, g.evaluate(x))
    assert eng.stats() == ref.stats()
    assert any(len(runs) > 1 for runs in acquired if runs)
    assert eng.slots._free == [(0, 96)]
    # the first waves ran around the held rows (0..6 and 20..24): zeros
    assert len(fragmented) == 2 and len(slabs) == 5
    assert not any(s[:7].any() or s[20:25].any() for s in fragmented)


def test_chain_request_by_runs_and_direct():
    pairs = [_graphs(30 + k, n_in, 120, n_out)
             for k, (n_in, n_out) in enumerate([(8, 6), (6, 5), (5, 4)])]
    x = _requests(31, 8, [150])[0]
    ref = RefEngine(RefSpec(n_unit=8), capacity=64, interpret=True)
    eng = LogicEngine(CompileSpec(n_unit=8), capacity=64, device="cpu")
    want = ref.serve_chain([r for r, _ in pairs], x)
    obs.clear()
    with obs.recording():
        got = eng.serve_chain([p for _, p in pairs], x)
    notes = _slab_notes()
    obs.clear()
    y = x
    for _, p in pairs:
        y = p.evaluate(y)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, y)
    assert notes == [(True, 1), (True, 1), (False, 1)]
    assert eng.stats() == ref.stats()


def _per_row_bookkeeping(capacity, reqs, out):
    """The per-row bookkeeping of a wave as the engine did it before rows
    were runs: ``SlotTable`` indices, a zeroed slab scattered by index,
    outputs gathered by index into each request's result."""
    table = SlotTable(capacity)
    t = time.perf_counter()
    admitted = [(x, table.acquire(len(x))) for x in reqs]
    bits = np.zeros((capacity, reqs[0].shape[1]), dtype=bool)
    for x, rows in admitted:
        bits[rows] = x
    for x, rows in admitted:
        result = np.zeros((len(x), out.shape[1]), dtype=bool)
        result[:] = out[rows]
        table.release(rows)
    return time.perf_counter() - t


@pytest.mark.parametrize("n", [5, 24])
def test_partial_waves_cost_no_more_than_per_row_bookkeeping(n):
    """A wave of many small requests: the whole ``step`` (queue, runs,
    slab by slices, retire by slices; the runner stubbed out) against the
    per-row bookkeeping alone, best of several interleaved tries."""
    _, g = _graphs(26)
    capacity = 2048
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=capacity,
                      device="cpu")
    out = np.zeros((capacity, g.n_outputs), dtype=bool)
    eng._entry(g).runners[eng._exec_key] = lambda bits: out
    pool = _requests(27, g.n_inputs, [capacity])[0]
    reqs = [pool[i:i + n] for i in range(0, capacity - n + 1, n)]
    by_runs = per_row = float("inf")
    for _ in range(7):
        uids = [eng.submit(g, x) for x in reqs]
        t = time.perf_counter()
        done = eng.step()
        by_runs = min(by_runs, time.perf_counter() - t)
        assert done == uids and eng.idle
        for u in uids:
            eng.result(u)
        per_row = min(per_row, _per_row_bookkeeping(capacity, reqs, out))
    assert by_runs <= per_row, (by_runs, per_row)


# ---------------------------------------------------------------------------
# RowRuns replayed against SlotTable
# ---------------------------------------------------------------------------

def _rows(runs):
    return [r for lo, hi in runs for r in range(lo, hi)]


def _runs_script(capacity: int, ops: list) -> None:
    """Replay (acquire n | cancel i) ops on a ``RowRuns`` and a
    ``SlotTable`` side by side: the same admissions and counts, runs that
    never overlap, the lowest free rows first, nothing leaked."""
    runs_t, slot_t = RowRuns(capacity), SlotTable(capacity)
    active: dict[int, tuple] = {}
    uid = 0
    for kind, arg in ops:
        if kind == "acquire":
            held = {r for runs, _ in active.values() for r in _rows(runs)}
            lowest = [r for r in range(capacity) if r not in held][:arg]
            runs, rows = runs_t.acquire(arg), slot_t.acquire(arg)
            assert (runs is None) == (rows is None)
            if runs is not None:
                assert _rows(runs) == lowest          # lowest first
                assert all(lo < hi for lo, hi in runs)
                assert all(a[1] < b[0] for a, b in zip(runs, runs[1:]))
                active[uid] = (runs, rows)
                uid += 1
        elif active:
            keys = sorted(active)
            runs, rows = active.pop(keys[arg % len(keys)])
            runs_t.release(runs)
            slot_t.release(rows)
        held = [r for runs, _ in active.values() for r in _rows(runs)]
        assert len(held) == len(set(held)), "row handed to two requests"
        free = _rows(runs_t._free)
        assert not set(free) & set(held)
        assert len(free) + len(held) == capacity
        assert all(a[1] < b[0] for a, b in zip(runs_t._free,
                                                runs_t._free[1:]))
        assert (runs_t.n_free, runs_t.n_active, runs_t.high_water) == \
            (slot_t.n_free, slot_t.n_active, slot_t.high_water)
    for runs, rows in active.values():          # drain: nothing leaked
        runs_t.release(runs)
        slot_t.release(rows)
    assert runs_t.n_free == capacity and runs_t._free == [(0, capacity)]
    assert runs_t.acquire(capacity) == [(0, capacity)]


@pytest.mark.parametrize("seed", range(8))
def test_row_runs_replay_slot_table(seed):
    """Seeded traces as ``SlotTable``'s cancellation fuzz draws them:
    ragged sizes incl. 0 and over-capacity, interleaved cancellations."""
    r = np.random.default_rng(seed)
    ops = []
    for _ in range(120):
        if r.random() < 0.6:
            ops.append(("acquire", int(r.integers(0, 40))))
        else:
            ops.append(("cancel", int(r.integers(0, 1 << 30))))
    _runs_script(int(r.integers(1, 97)), ops)


@pytest.mark.parametrize("bad, error", [
    ("double", RuntimeError), ("overlap", RuntimeError),
    ("twice_in_one", RuntimeError), ("past_capacity", ValueError),
    ("negative", ValueError), ("reversed", ValueError)])
def test_row_runs_release_guards(bad, error):
    t = RowRuns(8)
    runs = t.acquire(4)
    assert runs == [(0, 4)]
    if bad == "double":
        t.release(runs)
        arg = runs                      # cancel-after-retire must be loud
    else:
        arg = {"overlap": [(2, 6)], "twice_in_one": [(0, 2), (1, 3)],
               "past_capacity": [(6, 9)], "negative": [(-1, 2)],
               "reversed": [(3, 1)]}[bad]
    free = list(t._free)
    with pytest.raises(error):
        t.release(arg)
    assert t._free == free              # a release that raises frees nothing
    with pytest.raises(ValueError):
        t.acquire(-1)
    with pytest.raises(ValueError):
        RowRuns(0)


def test_cache_hits_structural_duplicate():
    _, g = _graphs(4)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=64, device="cpu")
    x = _requests(5, g.n_inputs, [20])[0]
    eng.serve(g, x)
    g2 = g.copy()
    g2.name = "same-structure-different-name"
    out = eng.serve(g2, x)
    assert (eng.cache.misses, eng.cache.hits) == (1, 1)
    np.testing.assert_array_equal(out, g.evaluate(x))


def test_shared_cache_engines_keep_their_own_runners():
    _, g = _graphs(6)
    cache = ProgramCache()
    a = LogicEngine(CompileSpec(n_unit=16), capacity=32, device="cpu",
                    cache=cache)
    b = LogicEngine(CompileSpec(n_unit=16), capacity=64, device="cpu",
                    cache=cache, use_ref=True)
    x = _requests(7, g.n_inputs, [40])[0]
    np.testing.assert_array_equal(a.serve(g, x), b.serve(g, x))
    entry = cache.peek(next(iter(cache._entries)))
    assert len(entry.runners) == 2 and cache.compiles == 1


def test_eviction_and_empty_requests():
    _, g1 = _graphs(8)
    _, g2 = _graphs(9)
    eng = LogicEngine(CompileSpec(n_unit=8), capacity=32, device="cpu",
                      max_programs=1)
    x1, x2 = _requests(10, g1.n_inputs, [40, 10])
    u1, u2 = eng.submit(g1, x1), eng.submit(g2, x2)    # g2 evicts g1
    u3 = eng.submit(g1, x1[:0])
    eng.drain()
    np.testing.assert_array_equal(eng.result(u1), g1.evaluate(x1))
    np.testing.assert_array_equal(eng.result(u2), g2.evaluate(x2))
    assert eng.result(u3).shape == (0, g1.n_outputs)
    with pytest.raises(KeyError):
        eng.result(u1)


# ---------------------------------------------------------------------------
# the runner's staged transfer (plain CPU tensors stand in for the pinned
# and the device buffer)
# ---------------------------------------------------------------------------

class _EnqueuedCopies:
    """Stands in for the device buffer: each chunk's copy is kept as it
    was enqueued (its rows, the bytes then in the source, ``non_blocking``)
    and written through."""

    def __init__(self, shape):
        self.buf = torch.zeros(shape, dtype=torch.bool)
        self.copies = []

    def __getitem__(self, rows):
        dst = self.buf[rows]
        lo = range(len(self.buf))[rows].start
        copies = self.copies

        class _Rows:
            def copy_(self, src, non_blocking=False):
                copies.append((lo, lo + len(src), src.clone(), non_blocking))
                dst.copy_(src)
        return _Rows()


def _chunk_rows(width):
    return max(1, STAGE_CHUNK_BYTES // width)


@pytest.mark.parametrize("rows,width", [
    (1, 400), ("one", 400), ("one+1", 400), (8192, 400), (8192, 2304)],
    ids=["1-row", "one-chunk", "one-chunk+1", "fc1", "conv8"])
def test_stage_rows_copies_every_row_once_in_order(rows, width):
    step = _chunk_rows(width)
    n = {"one": step, "one+1": step + 1}.get(rows, rows)
    bits = np.random.default_rng(n).integers(0, 2, (n, width)).astype(bool)
    host = torch.zeros((n, width), dtype=torch.bool)
    dev = _EnqueuedCopies((n, width))
    chunks = stage_rows(bits, host, dev)
    assert chunks == len(dev.copies) == -(-n // step)
    at = 0
    for lo, hi, src, non_blocking in dev.copies:
        assert lo == at and 0 < hi - lo <= step and non_blocking
        np.testing.assert_array_equal(src.numpy(), bits[lo:hi])
        at = hi
    assert at == n
    np.testing.assert_array_equal(host.numpy(), bits)
    np.testing.assert_array_equal(dev.buf.numpy(), bits)


def test_stage_rows_chunks_follow_the_slab_bytes():
    """fc1's 3.3 MB slab takes one or two chunks, conv8's 18.9 MB more."""
    assert -(-8192 // _chunk_rows(400)) <= 2
    assert -(-8192 // _chunk_rows(2304)) >= 2


def test_cpu_runner_notes_an_unstaged_transfer():
    _, g = _graphs(14)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=32, device="cpu")
    x = _requests(15, g.n_inputs, [40])[0]
    obs.clear()
    with obs.recording():
        np.testing.assert_array_equal(eng.serve(g, x), g.evaluate(x))
    h2d = [s.attrs for s in obs.spans() if s.label == "runner.h2d"]
    d2h = [s.attrs for s in obs.spans() if s.label == "runner.d2h"]
    assert len(h2d) == len(d2h) == eng.stats()["invocations"] == 2
    assert all(a == {"staged": False, "chunks": 0,
                     "bytes": 32 * g.n_inputs} for a in h2d)
    assert all(a == {"staged": False} for a in d2h)


# ---------------------------------------------------------------------------
# carrying the reference's state across (repro_torch.convert)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_gates", [None, 80])
def test_reference_artifact_executes_identically(max_gates):
    ref_g, _ = _graphs(11)
    ref_art = RefCompiler().compile(ref_g, RefSpec(n_unit=16,
                                                   max_gates=max_gates))
    art = artifact_from_reference(
        [p.to_payload() for p in ref_art.programs], ref_art.output_perm,
        ref_art.mode, spec=ref_art.spec.to_dict(),
        graph={"n_inputs": ref_art.graph.n_inputs,
               "gates": ref_art.graph.gates,
               "outputs": ref_art.graph.outputs,
               "name": ref_art.graph.name},
        compile_s=ref_art.compile_s)
    assert art.graph.fingerprint() == ref_art.graph.fingerprint()
    assert art.spec.cache_key() == CompileSpec.from_dict(
        ref_art.spec.to_dict()).cache_key()
    x = _requests(12, art.n_inputs, [77])[0]
    want = ref_art.execute(x)
    np.testing.assert_array_equal(art.execute(x), want)
    np.testing.assert_array_equal(
        mega_infer_bits(art.megaprogram(), x, device="cpu"), want)
    for ref_p, p in zip(ref_art.programs, art.programs):
        np.testing.assert_array_equal(
            logic_infer_bits(p, x, device="cpu"),
            execute_program_np(p, x))
        assert p.to_payload()[1] == ref_p.to_payload()[1]


def test_program_from_reference_rejects_unknown_fields():
    ref_g, _ = _graphs(13)
    arrays, scalars = RefCompiler().compile(
        ref_g, RefSpec(n_unit=8)).program.to_payload()
    p = program_from_reference(arrays, scalars)
    assert p.n_steps == len(arrays["src_a"])
    with pytest.raises(TypeError):
        program_from_reference({**arrays, "extra": np.zeros(1)}, scalars)


def test_reference_params_give_same_layer_graph():
    cfg = BinaryMLPConfig(n_features=16, hidden=(8,), n_classes=3, seed=0)
    ref_params = {k: np.asarray(v) for k, v in init_binary_mlp(cfg).items()}
    params = params_from_reference(ref_params)
    assert sorted(params) == ["b0", "b1", "w0", "w1"]
    x_bits = np.random.default_rng(0).integers(0, 2, (64, 16)) \
        .astype(np.uint8)
    ref = ref_layer_to_graph(x_bits, ref_params["w0"], ref_params["b0"],
                             mode="isf")
    port = layer_to_graph(x_bits, params["w0"], params["b0"], mode="isf")
    assert port.fingerprint() == ref.fingerprint()
    with pytest.raises(ValueError, match="keys"):
        params_from_reference({"w0": ref_params["w0"]})
    with pytest.raises(ValueError, match="fanin"):
        params_from_reference({**ref_params, "w1": ref_params["w0"],
                               "b1": ref_params["b0"]})
    with pytest.raises(ValueError, match="not \\(fin, fout\\)"):
        params_from_reference({**ref_params, "b1": ref_params["b0"]})
