"""FFCL-substituted FFN: the paper's technique inside a transformer block.

Port of ``src/repro/models/logic_mlp.py``, inference half.  With
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

The straight-through gradient of the reference's ``binary_ffn`` (training)
comes with the port's training slice; its forward value is the hard
threshold computed here.
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
    """The binarized FFN (the reference's inference path): x (..., D) ->
    y (..., D) in x's dtype, computed in float32."""
    return _project(binary_hidden(p, x), p, x)


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
