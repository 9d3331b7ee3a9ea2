"""The binarized conv layer computed plainly: the yardstick of
``flow/conv.py``'s served layer.

Output channel ``o`` at ``(y, x)`` fires iff ``conv2d(2m - 1, W)[o, y, x]
+ b[o] >= 0`` on the 0/1 maps ``m``, stride 1, with a padded position at
-1 (a 0 bit, as the served layer's receptive fields hold it).  Computed
in float64 with TF32 off: the terms are +-float32 weights, which float64
adds exactly in any order, so the bits do not depend on how the
convolution sums.  Plain PyTorch: nothing of the port's kernels.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _tf32_off():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def binarized_conv(maps, weight, bias, pad: int = 1,
                   device=None) -> torch.Tensor:
    """(N, C, H, W) 0/1 maps, ``weight`` (C_out, C, k, k), ``bias``
    (C_out,) -> (N, C_out, H', W') bool on ``device`` (the maps' own
    when None)."""
    x = torch.as_tensor(maps, device=device)
    dev = x.device
    w = torch.as_tensor(weight).to(dev, torch.float64)
    b = torch.as_tensor(bias).to(dev, torch.float64)
    pm1 = F.pad(2.0 * x.to(torch.float64) - 1.0, (pad,) * 4, value=-1.0)
    with _tf32_off():
        y = F.conv2d(pm1, w) + b[:, None, None]
    return y >= 0
