"""Port parity of the mega kernel's layer on the CPU, bit-exact.

The port's ``mega_infer_bits`` / ``mega_forward_words`` (``device="cpu"``,
the plain stage walk) against the reference's JAX megakernel in Pallas
interpret mode and the numpy oracle: chain and parallel modes, 2-4 stages,
mixed ``n_unit``, and gateless first, middle, last and all stages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.gate_ir import LogicGraph as RefGraph
from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.scheduler import build_megaprogram as ref_build_mega
from repro.core.scheduler import compile_graph as ref_compile
from repro.core.spec import CompileSpec as RefSpec
from repro.kernels.logic_dsp import ops as ref_ops
from repro_torch.core.gate_ir import LogicGraph, random_graph
from repro_torch.core.scheduler import (build_megaprogram, compile_graph,
                                        execute_megaprogram_np)
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp import ops


def _bits(seed, batch, n):
    return np.random.default_rng(seed).integers(0, 2, (batch, n)).astype(bool)


def _graphs(seed, n_in=8, n_gates=150, n_out=6, **kw):
    kw = dict(dict(unary_frac=0.2, locality=16), **kw)
    return (ref_random_graph(np.random.default_rng(seed), n_in, n_gates,
                             n_out, **kw),
            random_graph(np.random.default_rng(seed), n_in, n_gates, n_out,
                         **kw))


def _passthrough(cls, n, order=None):
    g = cls(n, name="pass")
    g.set_outputs([g.input_wire(i) for i in (order or range(n))])
    return g


def _mega_pair(layout, mode, perm=None, n_units=None):
    """Both packages' megaprograms for a stage layout: each entry is
    ``(n_in, n_gates, n_out)`` or ``("pass", n)`` for a gateless stage."""
    ref_progs, progs, graphs = [], [], []
    for k, stage in enumerate(layout):
        if stage[0] == "pass":
            ref_g = _passthrough(RefGraph, stage[1])
            g = _passthrough(LogicGraph, stage[1])
        else:
            ref_g, g = _graphs(100 + k, *stage)
        nu = (n_units or [8] * len(layout))[k]
        spec = dict(n_unit=nu, optimize="none")
        ref_progs.append(ref_compile(ref_g, RefSpec(**spec)))
        progs.append(compile_graph(g, CompileSpec(**spec)))
        graphs.append(g)
    kw = {} if perm is None else {"output_perm": np.asarray(perm)}
    return (ref_build_mega(ref_progs, mode=mode, **kw),
            build_megaprogram(progs, mode=mode, **kw), graphs)


MEGA_CASES = {
    "chain2": ([(6, 60, 5), (5, 50, 4)], "chain", None, None),
    "chain4_mixed_unit": ([(6, 60, 5), (5, 40, 5), (5, 50, 4), (4, 30, 3)],
                          "chain", None, [8, 64, 16, 8]),
    "gateless_first": ([("pass", 6), (6, 50, 4)], "chain", None, None),
    "gateless_middle": ([(6, 60, 4), ("pass", 4), (4, 40, 3)], "chain",
                        None, None),
    "gateless_last": ([(6, 60, 4), ("pass", 4)], "chain", None, None),
    "all_gateless": ([("pass", 4), ("pass", 4)], "chain", None, None),
    "parallel2": ([(6, 50, 2), (6, 40, 2)], "parallel", [2, 0, 3, 1],
                  None),
    "parallel3_mixed_unit": ([(6, 50, 3), (6, 40, 2), (6, 30, 2)],
                             "parallel", [6, 0, 3, 1, 5, 2, 4],
                             [8, 64, 16]),
    "parallel_gateless_stage": ([(6, 50, 3), ("pass", 6)], "parallel",
                                None, None),
}


@pytest.mark.parametrize("batch", [1, 70])
@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_mega_infer_bits_matches_reference(case, batch):
    layout, mode, perm, n_units = MEGA_CASES[case]
    ref_mega, mega, _ = _mega_pair(layout, mode, perm, n_units)
    x = _bits(batch, batch, mega.n_inputs)
    got = ops.mega_infer_bits(mega, x, device="cpu")
    want = ref_ops.mega_infer_bits(ref_mega, x)        # Pallas, interpret
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, execute_megaprogram_np(mega, x))


def test_mega_arrays_stage_table_and_out_rows():
    _, mega, _ = _mega_pair(*MEGA_CASES["parallel3_mixed_unit"][:2],
                            perm=MEGA_CASES["parallel3_mixed_unit"][2],
                            n_units=[8, 64, 16])
    arrs = ops.mega_arrays(mega, "cpu")
    np.testing.assert_array_equal(arrs["stage_table"].numpy(),
                                  np.asarray(mega.stage_meta))
    perm = np.asarray(mega.output_perm)
    np.testing.assert_array_equal(arrs["out_rows"].numpy()[perm],
                                  np.arange(len(perm)))
    assert ops.mega_arrays(mega, "cpu") is arrs
    assert arrs["dst"].shape == (mega.total_steps, mega.n_unit)
    np.testing.assert_array_equal(arrs["dst"].numpy(), mega.dst)


def test_mega_forward_words_matches_reference():
    ref_mega, mega, _ = _mega_pair(*MEGA_CASES["chain2"][:2])
    x = _bits(9, 100, mega.n_inputs)
    words = ops.pack_bits(torch.from_numpy(x))
    want = np.asarray(ref_ops.mega_forward_words(
        ref_mega, jnp.asarray(words.numpy())))
    np.testing.assert_array_equal(
        ops.mega_forward_words(mega, words).numpy(), want)
    np.testing.assert_array_equal(
        ops.mega_forward_words(mega, words, use_ref=True).numpy(), want)
