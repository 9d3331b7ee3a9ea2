"""The control: the reference computed one precision step down.

The configuration states float32 weights with exact sums (TF32 off); the
control computes the same stack with its products in TF32 (a 10-bit
mantissa, float32 sums), the step a float32 matrix product takes on the
card's tensor cores.  Neurons whose pre-activation lies within TF32's
rounding of zero flip, so the control serves wrong bits, and a
comparison that passes it is too loose.

On CUDA the product runs in TF32 on the card; elsewhere the weights are
rounded to TF32 (round to nearest even) and multiplied in float32, which
is what TF32 does (the +-1 inputs are exact in it).
"""
from __future__ import annotations

import numpy as np
import torch

TF32_MANTISSA = 10


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest even at a 10-bit mantissa."""
    drop = 23 - TF32_MANTISSA
    i = x.contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def tf32_stack(x01: np.ndarray, layers, device) -> np.ndarray:
    """The stack's outputs (bool) on ``device`` with TF32 products."""
    device = torch.device(device)
    h = torch.from_numpy(np.asarray(x01, dtype=np.uint8)).to(device)
    cuda = device.type == "cuda"
    old = torch.backends.cuda.matmul.allow_tf32 if cuda else None
    try:
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = True
        for layer in layers:
            W = torch.from_numpy(layer.W).to(device)
            b = torch.from_numpy(layer.b).to(device)
            x = 2.0 * h.to(torch.float32) - 1.0
            if not cuda:
                W = to_tf32(W)
            h = ((x @ W + b) >= 0).to(torch.uint8)
    finally:
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = old
    return h.bool().cpu().numpy()
