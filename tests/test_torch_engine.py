"""The port's LogicEngine against the reference's, on the CPU, bit-exact.

``repro_torch``'s ``LogicEngine(device="cpu")`` and ``repro``'s
``LogicEngine(interpret=True)`` serve the same ragged requests on the same
seeded graphs; outputs, ``stats()`` and cache behaviour must agree.  The
carry-across tests feed the port a reference artifact and reference MLP
parameters through ``repro_torch.convert``.
"""
import numpy as np
import pytest

from repro.core.compiler import LogicCompiler as RefCompiler
from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.nullanet import BinaryMLPConfig, init_binary_mlp
from repro.core.nullanet import layer_to_graph as ref_layer_to_graph
from repro.core.spec import CompileSpec as RefSpec
from repro.serve import LogicEngine as RefEngine
from repro_torch.convert import (artifact_from_reference,
                                 params_from_reference,
                                 program_from_reference)
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.nullanet import layer_to_graph
from repro_torch.core.scheduler import execute_program_np
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp.ops import logic_infer_bits, mega_infer_bits
from repro_torch.serve import LogicEngine, ProgramCache

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
