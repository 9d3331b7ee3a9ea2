"""The port's ``LogicEngine`` across devices: the counterparts of the
reference's sharded tests (``tests/test_serve_logic.py``: shared-cache
runners, the split path on one device, and data-parallel serving across
four devices), with CPU shards standing in for devices as the reference's
forced host devices do.  Every served bit is checked against
``g.evaluate`` and against the reference's one-device engine
(``repro.serve.LogicEngine``, Pallas interpret) on the same seeded
inputs.  Then the split's bookkeeping: ``stats()``, the capacity quantum,
the runner key, the default device list, and a failing shard raising."""
import numpy as np
import pytest
import torch

from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.spec import CompileSpec as RefSpec
from repro.serve import LogicEngine as RefEngine
from repro_torch.core.gate_ir import compose_graphs, random_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.serve import LogicEngine, ProgramCache
from repro_torch.serve import logic_engine as le

CPU4 = ["cpu"] * 4


def _graphs(seed, n_in=12, n_gates=300, n_out=10, locality=48):
    """The same random graph built by each package."""
    kw = dict(locality=locality)
    return (random_graph(np.random.default_rng(seed), n_in, n_gates, n_out,
                         **kw),
            ref_random_graph(np.random.default_rng(seed), n_in, n_gates,
                             n_out, **kw))


def _bits(seed, n, n_in):
    return np.random.default_rng(seed).integers(0, 2, (n, n_in)).astype(bool)


def test_shared_cache_engines_keep_their_own_runners():
    """Engines sharing a ProgramCache never run each other's runners: the
    split, its devices in order, the backend and the capacity are all in
    the runner key."""
    g, _ = _graphs(0)
    cache = ProgramCache()
    spec = CompileSpec(n_unit=16)
    engines = [
        LogicEngine(spec, capacity=32, use_ref=True, cache=cache,
                    device="cpu"),
        LogicEngine(spec, capacity=64, shard=True, cache=cache,
                    device="cpu"),
        LogicEngine(spec, capacity=64, devices=["cpu", "cpu"], cache=cache),
        LogicEngine(spec, capacity=64, devices=["cpu", "cpu"], shard=False,
                    cache=cache),
    ]
    X = _bits(1, 20, g.n_inputs)
    for eng in engines:
        assert (eng.serve(g, X) == g.evaluate(X)).all()
    assert cache.misses == 1 and cache.hits >= 3
    entry = cache.get(g, spec)
    assert len(entry.runners) == 4
    assert len({e._exec_key for e in engines}) == 4


def test_sharded_path_parity_single_device():
    """``shard=True`` on one device runs the split path there, exact."""
    g, ref_g = _graphs(2)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=64, shard=True,
                      device="cpu")
    assert eng.shard and eng.devices == (torch.device("cpu"),)
    X = _bits(3, 45, g.n_inputs)
    out = eng.serve(g, X)
    assert (out == g.evaluate(X)).all()
    ref = RefEngine(RefSpec(n_unit=16), capacity=64).serve(ref_g, X)
    assert (out == ref).all()
    s = eng.stats()
    assert (s["n_devices"], s["sharded"], s["capacity"]) == (1, True, 64)


@pytest.mark.parametrize("max_gates", [None, 80])
def test_sharded_parity_four_devices(max_gates):
    """Data-parallel serving across four CPU shards at one word each
    (capacity 128), 100 samples, monolithic and partitioned: bit-exact
    against ``g.evaluate`` and the reference's one-device engine."""
    g, ref_g = _graphs(1, n_in=10, n_gates=200, n_out=8, locality=32)
    eng = LogicEngine(CompileSpec(n_unit=16, max_gates=max_gates),
                      words_per_device=1, devices=CPU4)
    assert eng.shard and eng.capacity == 128
    X = _bits(4, 100, 10)
    out = eng.serve(g, X)
    assert (out == g.evaluate(X)).all()
    ref = RefEngine(RefSpec(n_unit=16, max_gates=max_gates)).serve(ref_g, X)
    assert (out == ref).all()
    if max_gates is not None:
        assert len(eng.cache.get(g, eng.spec).artifact.programs) >= 2
    s = eng.stats()
    assert (s["n_devices"], s["sharded"]) == (4, True)
    assert s["invocations"] == 1 and s["samples_served"] == 100


def test_sharded_waves_and_chains_are_exact():
    """Requests past one wave split into waves across the shards, and a
    stage chain runs through the split path too."""
    g, ref_g = _graphs(5, n_in=10, n_gates=200, n_out=8, locality=32)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=128, devices=CPU4)
    X = _bits(6, 300, 10)
    assert (eng.serve(g, X) == g.evaluate(X)).all()
    assert eng.stats()["invocations"] == 3
    ref = RefEngine(RefSpec(n_unit=16), capacity=128).serve(ref_g, X)
    assert (eng.serve(g, X) == ref).all()
    g1 = random_graph(np.random.default_rng(7), 10, 120, 9, locality=32)
    g2 = random_graph(np.random.default_rng(8), 9, 120, 6, locality=32)
    Xc = _bits(9, 77, 10)
    assert (eng.serve_chain([g1, g2], Xc) ==
            compose_graphs([g1, g2]).evaluate(Xc)).all()


@pytest.mark.parametrize("devices,capacity,want", [
    (CPU4, 100, 128), (CPU4, None, 512), (["cpu", "cpu"], 8190, 8192),
    (["cpu"], 8190, 8192), (["cpu"] * 3, 97, 192)])
def test_capacity_rounds_up_to_the_shard_quantum(devices, capacity, want):
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=capacity,
                      devices=devices)
    assert eng.capacity == want and eng.capacity % (32 * len(devices)) == 0
    assert eng.stats()["n_devices"] == len(devices)


def test_default_devices_are_every_visible_card(monkeypatch):
    """With no device named and more than one card visible the engine
    takes them all and splits over them, as the reference takes
    ``jax.devices()``; ``shard=False`` keeps one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    eng = LogicEngine(CompileSpec(n_unit=16))
    assert eng.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert eng.shard and eng.capacity == 32 * 4 * 2
    assert eng.device == torch.device("cuda", 0)
    one = LogicEngine(CompileSpec(n_unit=16), shard=False)
    assert one.devices == (torch.device("cuda", 0),) and not one.shard


def test_device_arguments_are_checked():
    with pytest.raises(ValueError, match="not both"):
        LogicEngine(CompileSpec(n_unit=16), device="cpu", devices=CPU4)
    with pytest.raises(ValueError, match="at least one"):
        LogicEngine(CompileSpec(n_unit=16), devices=[])
    with pytest.raises(ValueError, match="unsupported"):
        LogicEngine(CompileSpec(n_unit=16), devices=["cpu", "meta"])
    # a shared cache is checked against the engine's first device
    cache = ProgramCache(device="cpu")
    assert LogicEngine(CompileSpec(n_unit=16), devices=CPU4,
                       cache=cache).cache is cache


def test_a_failing_shard_raises(monkeypatch):
    """A shard whose launch fails raises out of the wave; nothing gives
    way to another executor."""
    g, _ = _graphs(10)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=128, devices=CPU4)
    real, calls = le.mega_forward_words, []

    def flaky(mega, words, **kw):
        calls.append(words.shape)
        if len(calls) == 3:
            raise RuntimeError("mega_kernel: launch failed")
        return real(mega, words, **kw)

    monkeypatch.setattr(le, "mega_forward_words", flaky)
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.serve(g, _bits(11, 50, g.n_inputs))
    # each shard packs its own block: one word of 32 rows each
    assert calls == [(g.n_inputs, 1)] * 3
