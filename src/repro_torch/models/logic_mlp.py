"""FFCL-substituted FFN: the paper's technique inside a transformer block.

Port of ``src/repro/models/logic_mlp.py``.  With
``cfg.logic_mlp = True`` a block's FFN is a *binarized* MLP
(NullaNet-compatible): the block input is binarized at a sign boundary,
the hidden activation is binary, and only the output projection is
numeric:

    xb = sign01(x);  h = sign01((2xb-1) @ w_in + b_in);  y = (2h-1) @ w_out

``ffn_to_program`` converts the xb -> h map of one layer through the
flow's one conversion path (``flow/convert.layer_to_program``: ISF from
calibration bits -> espresso -> gates -> synth -> schedule), and
``logic_ffn_apply`` runs it as a gate program on the packed words: no
``w_in`` matmul and no read of those weights (paper §7.1).  On a CUDA
tensor the program runs through K1 (``logic_forward`` ->
``logic_cuda_call``); on the CPU through the plain executor.  The
reference calls the plain executor even on its device, to stay jit-able
inside a transformer forward; PyTorch runs eagerly, so the port launches
the kernel.

Training uses the straight-through estimator of the reference's
``_ste01`` (an ``autograd.Function``): its forward is the exact hard
threshold ``y >= 0`` (the reference's ``soft + stop_gradient(hard - soft)``
equals it only up to float rounding, and the logic fabric must reproduce
the binary model's hidden bits exactly), and its backward is the soft
surrogate's derivative ``0.5 * (1 - tanh(y)**2)``, the reference's
gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scheduler import LogicProgram
from repro_torch.core.spec import CompileSpec, resolve_spec
from repro_torch.flow.convert import layer_to_program
from repro_torch.kernels.logic_dsp.ops import (logic_forward, pack_bits,
                                               unpack_bits)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


class _STE01(torch.autograd.Function):
    """(y >= 0) as y's dtype, with the gradient of 0.5 * (tanh(y) + 1)."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return (y >= 0).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        t = torch.tanh(y)
        return (0.5 * g * (1.0 - t * t)).to(y.dtype)


def ste01(y: torch.Tensor) -> torch.Tensor:
    """The straight-through binarizer: exact {0, 1} forward, the soft
    surrogate's gradient backward."""
    return _STE01.apply(y)


def binary_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The binarized FFN's hidden bits: x (..., D) -> h (N, F) bool over
    the flattened sample axis."""
    xb = (x.float() >= 0).reshape(-1, x.shape[-1]).float()
    return (2.0 * xb - 1.0) @ p["w_in"].float() + p["b_in"].float() >= 0


def logic_hidden(prog: LogicProgram, x: torch.Tensor) -> torch.Tensor:
    """The compiled program's hidden bits on x's device: x (..., D) ->
    h (N, F) bool.  The samples (the flattened leading axes) are packed 32
    to an int32 word, the paper's SIMD lanes."""
    xb = (x.float() >= 0).reshape(-1, x.shape[-1])
    out_words = logic_forward(prog, pack_bits(xb))
    return unpack_bits(out_words, xb.shape[0])


def _project(h: torch.Tensor, p: dict, x: torch.Tensor) -> torch.Tensor:
    y = (2.0 * h.float() - 1.0) @ p["w_out"].float()
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def binary_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The STE-binarized FFN (training and the reference inference path):
    x (..., D) -> y (..., D) in x's dtype, computed in float32 over the
    flattened samples.  Its hidden layer equals :func:`binary_hidden`'s
    bits; gradients flow through both thresholds by the STE."""
    xb = ste01(x.float().reshape(-1, x.shape[-1]))
    h = ste01((2.0 * xb - 1.0) @ p["w_in"].float() + p["b_in"].float())
    return _project(h, p, x)


def ffn_to_program(p: dict, calib_bits, spec: CompileSpec | None = None,
                   mode: str = "isf", name: str = "ffn") -> LogicProgram:
    """NullaNet conversion of the xb -> h map of one FFN layer: a thin
    wrapper over :func:`repro_torch.flow.convert.layer_to_program` with
    ``w_in`` and ``b_in`` taken to the host as float32."""
    spec = resolve_spec(spec, caller="ffn_to_program")
    return layer_to_program(_host(p["w_in"]), _host(p["b_in"]),
                            np.asarray(calib_bits, dtype=np.uint8), spec,
                            mode=mode, name=name)


def logic_ffn_apply(prog: LogicProgram, p: dict,
                    x: torch.Tensor) -> torch.Tensor:
    """Inference through the compiled FFCL program: x (B, S, D) ->
    y (B, S, D), bitwise ops for the hidden layer (K1 on the card) and the
    one numeric projection ``(2h - 1) @ w_out``."""
    return _project(logic_hidden(prog, x), p, x)
