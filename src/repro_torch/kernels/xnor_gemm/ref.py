"""Plain PyTorch versions of the XNOR GEMM.

``xnor_gemm_ref`` is the oracle of ``src/repro/kernels/xnor_gemm/ref.py``:
the dense +-1 product on unpacked bits.  ``xnor_packed_ref`` is the plain
twin of the CUDA kernel (``csrc/xnor_gemm.cu``): the same packed operands,
the same ``k_bits - 2 * popcount(a ^ b)``.  The CPU path runs it, and the
card's kernel is held against it.  ``xnor_and_popc_ref`` is the kernel's
own arithmetic, the AND-popcount identity its binary tensor-core
instruction computes, in plain PyTorch.
"""
from __future__ import annotations

import torch


def xnor_gemm_ref(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """a_bits: (M, K) {0,1}; b_bits: (N, K) {0,1} -> (M, N) int32 +-1 dot.

    The product runs in float64, which is exact here (|dot| <= K < 2**53)
    and has a matmul on every device; CUDA has no int32 one."""
    a = 2.0 * torch.as_tensor(a_bits).to(torch.float64) - 1.0
    b = 2.0 * torch.as_tensor(b_bits).to(torch.float64) - 1.0
    return (a @ b.T).to(torch.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int32.  Each 16-bit half is counted
    on its own, so no intermediate leaves [0, 2**16) and nothing overflows
    (PyTorch has no unsigned 32-bit arithmetic)."""
    total = torch.zeros_like(x)
    for half in (x & 0xFFFF, (x >> 16) & 0xFFFF):
        v = half - ((half >> 1) & 0x5555)
        v = (v & 0x3333) + ((v >> 2) & 0x3333)
        v = (v + (v >> 4)) & 0x0F0F
        total += (v + (v >> 8)) & 0x1F
    return total


def xnor_packed_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                    k_bits: int) -> torch.Tensor:
    """(M, Kw) x (N, Kw) int32 words -> (M, N) int32
    ``k_bits - 2 * sum_w popcount(a[m, w] ^ b[n, w])``, one word at a
    time so that no (M, N, Kw) temporary is made."""
    m, kw = a_packed.shape
    n, kw2 = b_packed.shape
    if kw != kw2:
        raise ValueError(f"K-word mismatch: {kw} vs {kw2}")
    acc = torch.zeros((m, n), dtype=torch.int32, device=a_packed.device)
    for w in range(kw):
        acc += _popcount(a_packed[:, w, None] ^ b_packed[None, :, w])
    return k_bits - 2 * acc


def xnor_and_popc_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                      k_bits: int) -> torch.Tensor:
    """What ``xnor_kernel`` computes, by its route: ``popc(a ^ b) =
    popc(a) + popc(b) - 2 popc(a & b)``, so the result is
    ``k_bits - 2 (pa[m] + pb[n]) + 4 sum_w popc(a[m, w] & b[n, w])`` with
    ``pa``, ``pb`` the rows' popcounts.  Zero words past the real K (the
    kernel's padding) count nothing on either side."""
    m, kw = a_packed.shape
    n, kw2 = b_packed.shape
    if kw != kw2:
        raise ValueError(f"K-word mismatch: {kw} vs {kw2}")
    pa = _popcount(a_packed).sum(dim=1, dtype=torch.int32)
    pb = _popcount(b_packed).sum(dim=1, dtype=torch.int32)
    both = torch.zeros((m, n), dtype=torch.int32, device=a_packed.device)
    for w in range(kw):
        both += _popcount(a_packed[:, w, None] & b_packed[None, :, w])
    return k_bits - 2 * (pa[:, None] + pb[None, :]) + 4 * both
