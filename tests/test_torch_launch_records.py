"""The process-wide launch records (``ops.LAUNCH_RECORDS``) on the CPU.

The CUDA kernel reads one index record per lane and step, in a lane order
(``ops.bank_order``) that takes a greedy pass over every lane to build.
They depend only on a program's streams, so ``ops.launch_records`` keeps
the host records by a hash of the streams' bytes: a program loaded anew
from the artifact store after an eviction uploads them and builds nothing.
Here: cached records equal a fresh build array for array in each scratch
variant and column count, a store reload behind a ``LogicEngine`` serves
the same bits with no second build, and the cache keeps its bound, under
threads too.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.scheduler import compile_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp import kernel as K
from repro_torch.kernels.logic_dsp import ops
from repro_torch.serve import LogicEngine


@pytest.fixture
def records(monkeypatch):
    """A fresh, empty process cache for the test."""
    cache = ops.LaunchRecordCache(max_entries=16, max_bytes=4 << 20)
    monkeypatch.setattr(ops, "LAUNCH_RECORDS", cache)
    return cache


def _program(seed, n_gates=300, n_unit=64):
    g = random_graph(np.random.default_rng(seed), 10, n_gates, 6,
                     unary_frac=0.2, locality=24)
    return compile_graph(g, CompileSpec(n_unit=n_unit, optimize="none"))


def _streams(p):
    return (p.src_a, p.src_b, p.dst, p.opcode, p.step_branch)


# scratch variant, columns a block, and the rows it is planned for: a
# program past 2 columns' shared memory takes 1; 4 when the block may
# hold 4
@pytest.mark.parametrize("scratch,cols,n_addr", [
    ("shared", 2, None), ("shared", 1, 40_000), ("shared", 4, None),
    ("device", 2, None)])
def test_cached_records_equal_a_fresh_build(records, monkeypatch, scratch,
                                            cols, n_addr):
    """The first call builds, the second hits, and both equal
    ``_build_records`` on the same streams array for array, plan for plan;
    streams of another int width (as a store load may give) hit too."""
    if cols == 4:
        monkeypatch.setattr(K, "COLS_PER_BLOCK", 4)
    p = _program(cols)
    n_addr = n_addr or p.n_addr
    kw = dict(n_addr=n_addr, trash=p.trash_addr, scratch=scratch)
    first = ops.launch_records(*_streams(p), **kw)
    again = ops.launch_records(*(np.asarray(x, dtype=np.int64)
                                 for x in _streams(p)), **kw)
    rec, plan = ops._build_records(*_streams(p), n_addr, p.trash_addr,
                                   scratch, False)
    assert (plan.scratch, plan.cols) == (scratch, cols)
    assert first["plan"] == again["plan"] == plan
    for got in (first, again):
        assert got["rec"].dtype == torch.int32
        np.testing.assert_array_equal(got["rec"].numpy(), rec.numpy())
    assert records.stats()["builds"] == 1 and records.stats()["hits"] == 1
    # each caller gets its own copy: writing one leaves the cache whole
    first["rec"].zero_()
    np.testing.assert_array_equal(
        ops.launch_records(*_streams(p), **kw)["rec"].numpy(), rec.numpy())


def test_records_key_names_everything_the_records_read():
    """A change to any stream, the trash rows, ``n_addr``, the pinned
    variant or the barrier proof is another key; an int width is not."""
    p = _program(5)
    base = dict(n_addr=p.n_addr, trash=p.trash_addr, scratch=None,
                two_barriers=False)
    key = ops.records_key(_streams(p), **base)
    assert ops.records_key([np.asarray(x, dtype=np.int64)
                            for x in _streams(p)], **base) == key
    for i in range(5):
        s = [np.array(x) for x in _streams(p)]
        s[i].flat[0] += 1
        assert ops.records_key(s, **base) != key
    for change in (dict(n_addr=p.n_addr + 1), dict(trash=None),
                   dict(trash=p.trash_addr + 1), dict(scratch="device"),
                   dict(two_barriers=True)):
        assert ops.records_key(_streams(p), **{**base, **change}) != key


@pytest.mark.parametrize("max_gates", [None, 120])
def test_store_reload_serves_the_same_bits_without_a_second_build(
        records, tmp_path, max_gates):
    """A ``LogicEngine(device="cpu")`` over an artifact store: its program
    evicted from the ``ProgramCache`` comes back from the store as new
    objects (a new ``MegaProgram``: the per-object memo misses), serves the
    same bits, and its launch records are built once in all."""
    g = random_graph(np.random.default_rng(7), 12, 400, 8, locality=48)
    spec = CompileSpec(n_unit=32, max_gates=max_gates)
    engine = LogicEngine(spec, capacity=64, store=ArtifactStore(tmp_path),
                         device="cpu")
    x = np.random.default_rng(8).integers(0, 2, (50, 12)).astype(bool)
    first = engine.serve(g, x)
    cache = engine.cache
    key = cache.get(g, engine.spec).key
    mega = cache.peek(key).artifact.megaprogram()
    assert len(mega.stage_meta) == (1 if max_gates is None else
                                     len(cache.peek(key).programs))
    assert records.stats()["builds"] == 1
    assert cache.evict(key) == key
    again = engine.serve(g, x)
    reloaded = cache.peek(key).artifact.megaprogram()
    assert reloaded is not mega
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(again, g.evaluate(x))
    st = cache.stats()
    assert (st["compiles"], st["store_hits"]) == (1, 1)
    assert records.stats()["builds"] == 1 and records.stats()["hits"] == 1


def _rec(n_bytes):
    return torch.zeros(n_bytes // 4, dtype=torch.int32)


@pytest.mark.parametrize("max_entries,max_bytes,sizes,kept", [
    (3, 1 << 20, [400] * 6, [3, 4, 5]),                 # by entries
    (8, 1000, [400] * 6, [4, 5]),                       # by bytes
    (8, 1000, [400, 2000, 400], [0, 2]),                # too large to keep
])
def test_cache_stays_within_its_bound(max_entries, max_bytes, sizes, kept):
    """Least recently used first, entries and bytes both bounded; a set
    larger than the byte bound is returned and not kept."""
    cache = ops.LaunchRecordCache(max_entries, max_bytes)
    for i, n in enumerate(sizes):
        rec, _ = cache.get(bytes([i]), lambda n=n: (_rec(n), None))
        assert rec.numel() * 4 == n
        st = cache.stats()
        assert st["entries"] <= max_entries and st["bytes"] <= max_bytes
    assert list(cache._entries) == [bytes([i]) for i in kept]
    assert cache.stats()["bytes"] == sum(sizes[i] for i in kept)
    assert cache.stats()["builds"] == len(sizes)


def test_cache_under_threads_keeps_its_counts_and_bound():
    """16 threads on 6 keys against a 4-entry cache, switching often:
    every call is a hit or a build, what a key returns is always its own
    records, and the entries and bytes stay within the bound."""
    cache = ops.LaunchRecordCache(max_entries=4, max_bytes=4 * 400)
    errors, calls = [], 16 * 300
    old = sys.getswitchinterval()

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(calls // 16):
                k = int(rng.integers(6))
                rec, _ = cache.get(bytes([k]), lambda k=k: (
                    torch.full((100,), k, dtype=torch.int32), k))
                assert bool((rec == k).all())
        except Exception as exc:          # noqa: BLE001 — reported below
            errors.append(exc)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    st = cache.stats()
    assert st["hits"] + st["builds"] == calls
    assert st["entries"] <= 4 and st["bytes"] == 400 * st["entries"]
