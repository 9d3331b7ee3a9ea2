"""Bind and launch the hand-written CUDA XNOR-popcount GEMM (K3).

The kernel lives in ``repro_torch/csrc/xnor_gemm.cu`` and replaces the
Pallas ``_xnor_kernel`` / ``xnor_gemm_pallas`` of
``src/repro/kernels/xnor_gemm/kernel.py``.  It runs on the binary tensor
cores (b1 ``mma.sync`` with AND-popc; ``ref.xnor_and_popc_ref`` is its
arithmetic in plain PyTorch).  ``repro_torch.kernels.native`` builds it
with the port's other CUDA sources into one library at first use.
The wrapper takes CUDA tensors only, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises on a launch error and counts its launches (``launch_count("xnor")``).
The plain PyTorch version is ``ref.xnor_packed_ref``; ``ops.py`` picks
between them by device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.native import (count_launch, launch_count, library,
                                        raise_on, reset_launch_counts)

__all__ = ["launch_count", "reset_launch_counts", "xnor_cuda_call"]

_TILE_N = 128           # output columns a block owns (xnor_gemm.cu)
_MAX_GRID_Y = 65_535    # N tiles go on the grid's y axis


def xnor_cuda_call(a_packed: torch.Tensor, b_packed: torch.Tensor,
                   k_bits: int) -> torch.Tensor:
    """Launch K3: (M, Kw) x (N, Kw) int32 words -> (M, N) int32
    ``k_bits - 2 * popcount(a ^ b)`` summed over the words.

    Both operands must be contiguous int32 CUDA tensors on one device,
    with the same ``Kw`` and ``0 <= k_bits <= 32 * Kw``.  An empty output
    launches nothing."""
    for name, t in (("a_packed", a_packed), ("b_packed", b_packed)):
        if t.device.type != "cuda" or t.device != a_packed.device:
            raise ValueError(f"{name} must be a CUDA tensor on "
                             f"{a_packed.device}, got {t.device} (the kernel "
                             "takes no CPU tensor)")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, kw = a_packed.shape
    n, kw2 = b_packed.shape
    if kw != kw2:
        raise ValueError(f"K-word mismatch: {kw} vs {kw2}")
    if not 0 <= k_bits <= 32 * kw:
        raise ValueError(f"k_bits={k_bits} does not fit {kw} words")
    if -(-n // _TILE_N) > _MAX_GRID_Y or max(m, n, kw) >= 2 ** 31:
        raise ValueError(f"shape ({m}, {n}, {kw}) exceeds the launch grid")
    out = torch.empty((m, n), dtype=torch.int32, device=a_packed.device)
    if out.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(a_packed.device):
        stream = torch.cuda.current_stream(a_packed.device).cuda_stream
        err = lib.xnor_gemm_launch(a_packed.data_ptr(), b_packed.data_ptr(),
                                   out.data_ptr(), m, n, kw, int(k_bits),
                                   stream)
    raise_on(err, "xnor_kernel")
    count_launch("xnor")
    return out
