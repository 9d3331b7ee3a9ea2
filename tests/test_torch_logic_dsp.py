"""Port parity of the logic_dsp layer on the CPU, bit-exact (tolerance 0).

The port's plain executors and its ``ops`` entry points (``device="cpu"``)
are held against the reference's JAX functions, with Pallas in interpret
mode as the reference's own tests run it, and against the numpy oracles.
Each package compiles its own program from the same seeded graph.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.gate_ir import CONST1 as REF_CONST1
from repro.core.gate_ir import LogicGraph as RefGraph
from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.scheduler import compile_graph as ref_compile
from repro.core.spec import CompileSpec as RefSpec
from repro.kernels.logic_dsp import ops as ref_ops
from repro.kernels.logic_dsp.ref import apply_opcode_jnp
from repro_torch.core.gate_ir import CONST1, LogicGraph, random_graph
from repro_torch.core.scheduler import compile_graph, execute_program_np
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp import ops
from repro_torch.kernels.logic_dsp.ref import (apply_opcode, apply_step,
                                               logic_forward_ref)

BATCHES = [1, 31, 32, 33, 70]


def _bits(seed, batch, n):
    return np.random.default_rng(seed).integers(0, 2, (batch, n)).astype(bool)


def _graphs(seed, n_in=8, n_gates=150, n_out=6, **kw):
    kw = dict(dict(unary_frac=0.2, locality=16), **kw)
    return (ref_random_graph(np.random.default_rng(seed), n_in, n_gates,
                             n_out, **kw),
            random_graph(np.random.default_rng(seed), n_in, n_gates, n_out,
                         **kw))


def _compile_both(seed, spec_kw, **graph_kw):
    ref_g, g = _graphs(seed, **graph_kw)
    return (ref_compile(ref_g, RefSpec(**spec_kw)),
            compile_graph(g, CompileSpec(**spec_kw)), g)


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", BATCHES + [64, 65])
def test_pack_bits_same_words_as_reference(batch):
    x = _bits(batch, batch, 7)
    x[:, 0] = True                   # bit 31 set in every full word
    words = ops.pack_bits(torch.from_numpy(x))
    ref = np.asarray(ref_ops.pack_bits_jnp(jnp.asarray(x)))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), ref)
    if batch >= 32:
        assert (words[0, :batch // 32] == -1).all()
    back = ops.unpack_bits(words, batch).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(ref_ops.unpack_bits_jnp(jnp.asarray(ref), batch)))


def test_unpack_sign_bit_words():
    words = torch.tensor([[-2 ** 31, -1, 0, 2 ** 31 - 1]], dtype=torch.int32)
    ref = np.asarray(ref_ops.unpack_bits_jnp(jnp.asarray(words.numpy()),
                                             128))
    np.testing.assert_array_equal(ops.unpack_bits(words, 128).numpy(), ref)
    np.testing.assert_array_equal(
        ops.pack_bits(ops.unpack_bits(words, 128)).numpy(), words.numpy())


# ---------------------------------------------------------------------------
# opcode dispatch
# ---------------------------------------------------------------------------

def test_apply_opcode_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(-2 ** 31, 2 ** 31, (10, 5), dtype=np.int64) \
        .astype(np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31, (10, 5), dtype=np.int64) \
        .astype(np.int32)
    op = np.arange(10, dtype=np.int32)[:, None]      # 0..8 plus unknown 9
    got = apply_opcode(torch.from_numpy(op), torch.from_numpy(a),
                       torch.from_numpy(b)).numpy()
    want = np.asarray(apply_opcode_jnp(jnp.asarray(op), jnp.asarray(a),
                                       jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for k in range(9):                   # each bank == the select at k
        want_k = np.asarray(apply_opcode_jnp(
            jnp.full((10, 1), k, jnp.int32), jnp.asarray(a), jnp.asarray(b)))
        got_k = apply_step(k, torch.full((10,), k, dtype=torch.int32), ta, tb)
        np.testing.assert_array_equal(got_k.numpy(), want_k)
    mixed = apply_step(9, torch.from_numpy(op[:, 0]), ta, tb)
    np.testing.assert_array_equal(mixed.numpy(), want)


# ---------------------------------------------------------------------------
# single-program execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("alloc", ["direct", "liveness"])
@pytest.mark.parametrize("n_unit", [8, 64])
def test_logic_infer_bits_matches_reference(n_unit, alloc, batch):
    spec = dict(n_unit=n_unit, alloc=alloc, optimize="none")
    ref_p, p, g = _compile_both(n_unit + batch, spec)
    x = _bits(batch, batch, p.n_inputs)
    got = ops.logic_infer_bits(p, x, device="cpu")
    want = ref_ops.logic_infer_bits(ref_p, x)          # Pallas, interpret
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, execute_program_np(p, x))
    np.testing.assert_array_equal(got, g.evaluate(x))


def test_mixed_steps_match_reference():
    """opcode_sort off leaves mixed-opcode steps (branch MIXED_DISPATCH)."""
    spec = dict(n_unit=16, opcode_sort=False, optimize="none")
    ref_p, p, g = _compile_both(3, spec)
    assert (p.step_branch == 9).any() and (p.step_branch < 9).any()
    x = _bits(3, 70, p.n_inputs)
    got = ops.logic_infer_bits(p, x, device="cpu")
    np.testing.assert_array_equal(got, ref_ops.logic_infer_bits(ref_p, x))
    np.testing.assert_array_equal(got, execute_program_np(p, x))


def test_word_level_entry_points_match_reference():
    ref_p, p, _ = _compile_both(4, dict(n_unit=8, optimize="none"))
    x = _bits(4, 45, p.n_inputs)
    words = ops.pack_bits(torch.from_numpy(x))
    want = np.asarray(ref_ops.logic_forward(ref_p, jnp.asarray(words.numpy())))
    np.testing.assert_array_equal(ops.logic_forward(p, words).numpy(), want)
    arrs = ops.program_arrays(p, "cpu")
    np.testing.assert_array_equal(
        ops.forward_words(arrs["src_a"], arrs["src_b"], arrs["dst"],
                          arrs["opcode"], arrs["step_branch"],
                          arrs["output_addrs"], words,
                          n_addr=arrs["n_addr"]).numpy(), want)
    # the generic dispatch (no step_branch) computes the same words
    np.testing.assert_array_equal(
        logic_forward_ref(arrs["src_a"], arrs["src_b"], arrs["dst"],
                          arrs["opcode"], words, arrs["output_addrs"],
                          arrs["n_addr"]).numpy(), want)


def test_program_arrays_memo_per_device():
    _, p, _ = _compile_both(5, dict(n_unit=6, optimize="none"))
    a1 = ops.program_arrays(p, "cpu")
    assert ops.program_arrays(p, "cpu") is a1
    assert ops.program_arrays(p, torch.device("cpu")) is a1
    assert a1["src_a"].shape == (p.n_steps, 6)       # lanes are not padded
    for k in ("src_a", "src_b", "dst", "opcode", "step_branch",
              "output_addrs"):
        np.testing.assert_array_equal(a1[k].numpy(), getattr(p, k))
    x = _bits(5, 40, p.n_inputs)
    words = ops.pack_bits(torch.from_numpy(x))
    out = ops.forward_words(a1["src_a"], a1["src_b"], a1["dst"],
                            a1["opcode"], a1["step_branch"],
                            a1["output_addrs"], words, n_addr=a1["n_addr"])
    np.testing.assert_array_equal(ops.unpack_bits(out, 40).numpy(),
                                  execute_program_np(p, x))


def test_gateless_program_matches_reference():
    ref_g, g = RefGraph(5, name="pass"), LogicGraph(5, name="pass")
    ref_g.set_outputs([ref_g.input_wire(i) for i in (4, 0, 2)] + [REF_CONST1])
    g.set_outputs([g.input_wire(i) for i in (4, 0, 2)] + [CONST1])
    spec = dict(n_unit=8, optimize="none")
    ref_p, p = ref_compile(ref_g, RefSpec(**spec)), \
        compile_graph(g, CompileSpec(**spec))
    assert p.n_steps == 0
    x = _bits(6, 33, 5)
    got = ops.logic_infer_bits(p, x, device="cpu")
    np.testing.assert_array_equal(got, ref_ops.logic_infer_bits(ref_p, x))
    np.testing.assert_array_equal(got, g.evaluate(x))


def test_bad_program_address_refused():
    _, p, _ = _compile_both(7, dict(n_unit=8, optimize="none"))
    bad = p.__class__(**{**p.__dict__, "n_addr": 3})
    with pytest.raises(ValueError, match="outside"):
        ops.program_arrays(bad, "cpu")
    words = ops.pack_bits(torch.from_numpy(_bits(7, 40, p.n_inputs - 1)))
    with pytest.raises(ValueError, match="input words"):
        ops.logic_forward(p, words)
