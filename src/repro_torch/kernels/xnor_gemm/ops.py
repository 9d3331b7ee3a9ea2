"""Public API over the XNOR GEMM kernel.

Port of ``src/repro/kernels/xnor_gemm/ops.py``.  :func:`xnor_gemm` runs on
``device="cuda"`` unless told otherwise and raises when no CUDA device is
present; ``device="cpu"`` is the explicit opt-in to the plain PyTorch
version.  On a CUDA tensor it launches the kernel (``kernel.py``), on a CPU
tensor it takes ``ref.xnor_packed_ref``; it never falls back.  The TPU
version padded M, N and Kw to its block sizes; the CUDA kernel masks its
ragged edges itself, so nothing is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.logic_dsp.ops import pack_bits, resolve_device
from repro_torch.kernels.xnor_gemm import kernel as _k
from repro_torch.kernels.xnor_gemm.ref import xnor_packed_ref

WORD_BITS = 32


def pack_pm1(bits) -> torch.Tensor:
    """(R, K) {0,1} bits -> (R, ceil(K/32)) int32, K packed LSB-first.

    Bit k of word w of row r is ``bits[r, 32*w + k]``: the words of
    :func:`~repro_torch.kernels.logic_dsp.ops.pack_bits` on the transpose.
    A set bit 31 makes the word negative, as the reference's uint32 sum
    cast to int32 does.  The bits are taken as bool (nonzero is 1), the
    dtype the pack kernel reads; its wrapper copies the transposed view
    contiguous."""
    return pack_bits(torch.as_tensor(bits).to(torch.bool).T)


def xnor_gemm(a_bits, b_bits, device=None) -> torch.Tensor:
    """Binarized +-1 GEMM: a (M, K) {0,1} x b (N, K) {0,1} -> (M, N) int32
    on ``device``."""
    dev = resolve_device(device)
    a = torch.as_tensor(a_bits, device=dev)
    b = torch.as_tensor(b_bits, device=dev)
    m, k = a.shape
    n, k2 = b.shape
    if k != k2:
        raise ValueError(f"K mismatch: {k} vs {k2}")
    ap, bp = pack_pm1(a), pack_pm1(b)
    if dev.type == "cpu":
        return xnor_packed_ref(ap, bp, k)
    return _k.xnor_cuda_call(ap, bp, k)
