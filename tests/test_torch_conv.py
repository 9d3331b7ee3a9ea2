"""A binarized conv layer as one NullaNet program (``flow/conv.py``): maps
to receptive-field rows and back, synthesis from the fields, serving
through ``LogicEngine``, held bit for bit to the plain reference
(``flow/conv_ref.py``); and the launch plan past a block's shared
memory."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.spec import CompileSpec
from repro_torch.flow.conv import (conv_to_graph, fold_bits, serve_conv,
                                   unfold_bits)
from repro_torch.flow.conv_ref import binarized_conv
from repro_torch.kernels.logic_dsp.kernel import plan_launch
from repro_torch.serve import LogicEngine


def _maps(seed, shape):
    return np.random.default_rng(seed).integers(0, 2, shape, dtype=np.uint8)


@pytest.mark.parametrize("k,pad", [(3, 1), (3, 0), (2, 1), (1, 0)])
def test_unfold_bits_is_torch_unfold_on_0_1_maps(k, pad):
    maps = _maps(1, (3, 5, 4, 6))
    rows = unfold_bits(maps, k, pad)
    want = F.unfold(torch.from_numpy(maps).double(), k, padding=pad)
    n, ck, positions = want.shape
    assert rows.dtype == bool
    np.testing.assert_array_equal(
        rows, want.permute(0, 2, 1).reshape(n * positions, ck).bool().numpy())


def test_fold_bits_inverts_the_row_order():
    maps = _maps(2, (4, 7, 3, 5)).astype(bool)
    rows = maps.transpose(0, 2, 3, 1).reshape(-1, 7)   # one row a position
    np.testing.assert_array_equal(fold_bits(rows, 4, 3, 5), maps)
    # a 1x1 field is the position's own channels
    np.testing.assert_array_equal(unfold_bits(maps, 1, 0), rows)
    with pytest.raises(ValueError):
        fold_bits(rows, 4, 3, 4)


def test_reference_pads_with_minus_one():
    """A padded position is a 0 bit: -1 in the +-1 form."""
    maps = _maps(3, (2, 2, 3, 3))
    w = np.random.default_rng(4).standard_normal((5, 2, 3, 3)).astype(
        np.float32)
    b = np.float32(0.1) * np.arange(5, dtype=np.float32)
    padded = np.pad(maps, ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = F.conv2d(2.0 * torch.from_numpy(padded).double() - 1.0,
                    torch.from_numpy(w).double()) \
        + torch.from_numpy(b).double()[:, None, None] >= 0
    got = binarized_conv(maps, w, b)
    assert got.shape == (2, 5, 3, 3) and got.dtype == torch.bool
    assert torch.equal(got, want)


def test_conv_served_through_the_engine_is_the_reference_bit_for_bit():
    """A 3x3 conv of 8 -> 16 channels on 4x4 maps of 25 images: its 400
    receptive fields are the ISF, the maps are served, folded back, and
    equal the plain reference."""
    rng = np.random.default_rng(30)
    maps = rng.integers(0, 2, (25, 8, 4, 4), dtype=np.uint8)
    weight = rng.standard_normal((16, 8, 3, 3), dtype=np.float32)
    bias = 0.1 * rng.standard_normal(16, dtype=np.float32)
    graph = conv_to_graph(maps, weight, bias)
    assert (graph.n_inputs, graph.n_outputs) == (72, 16)
    eng = LogicEngine(CompileSpec(n_unit=16, optimize="none"), capacity=256,
                      device="cpu")
    served = serve_conv(eng, graph, maps)
    want = binarized_conv(maps, weight, bias).numpy()
    assert served.shape == (25, 16, 4, 4)
    np.testing.assert_array_equal(served, want)
    assert 0 < want.sum() < want.size
    assert eng.invocations == 2                  # 400 rows, 256 a wave


@pytest.mark.parametrize("n_addr,scratch", [
    (14_108, "shared"),     # LeNet-5 fc1: 36k gates, two columns a block
    (56_000, "shared"),     # one column still fits
    (62_200, "device"),     # VGG16 conv8: 2,304 inputs + 512 x ~117 rows
    (66_000, "device")])
def test_plan_launch_takes_the_device_variant_past_shared_memory(n_addr,
                                                                 scratch):
    assert plan_launch(n_addr, 256, True).scratch == scratch


def test_serve_conv_reads_the_field_size_from_the_graph():
    rng = np.random.default_rng(31)
    maps = rng.integers(0, 2, (2, 3, 3, 3), dtype=np.uint8)
    weight = rng.standard_normal((4, 3, 1, 1), dtype=np.float32)
    bias = np.zeros(4, dtype=np.float32)
    graph = conv_to_graph(maps, weight, bias, pad=0)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=64, device="cpu")
    np.testing.assert_array_equal(serve_conv(eng, graph, maps, pad=0),
                                  binarized_conv(maps, weight, bias,
                                                 pad=0).numpy())
    with pytest.raises(ValueError):
        serve_conv(eng, graph, maps[:, :2])
