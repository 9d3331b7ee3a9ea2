"""Int8 error-feedback gradient compression for the cross-pod all-reduce.

Port of ``src/repro/optim/compression.py``.  Blockwise symmetric int8
quantization, 256 elements a block, one float32 scale a block, rounded
half to even (``torch.round`` as ``jnp.round``), so ``q`` equals the
reference's bit for bit.  Error feedback carries the quantization
residual into the next step [Seide et al. 2014; Karimireddy et al. 2019,
arXiv:1901.09847].  The trainer, with a mesh or without, uses only the
int8 round trip, which models the all-reduce's wire format: the
reference's step keeps no error-feedback state, so neither does the
port's, and no step calls ``ef_compress`` / ``ef_decompress_apply``
(ported with the module, held against the reference by the tests).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_BLOCK = 256


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % mult
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return flat


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization: (q int8 (n_blocks, 256),
    scale float32 (n_blocks, 1))."""
    flat = _pad_to(g.float(), _BLOCK).reshape(-1, _BLOCK)
    amax = flat.abs().amax(dim=1, keepdim=True)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


class ErrorFeedbackState(NamedTuple):
    residual: dict     # name -> float32 tensor, like the grads


def ef_init(params: dict) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in params.items()})


def ef_compress(g: torch.Tensor, residual: torch.Tensor):
    """Quantize (g + residual); return (q, scale, new_residual)."""
    target = g.float() + residual
    q, scale = compress_int8(target)
    recon = decompress_int8(q, scale, target.shape)
    return q, scale, target - recon


def ef_decompress_apply(q_sum: torch.Tensor, scale: torch.Tensor, shape,
                        n_participants: int) -> torch.Tensor:
    """Average of a summed (q * scale) representation over
    ``n_participants``."""
    return decompress_int8(q_sum, scale, shape) / n_participants
