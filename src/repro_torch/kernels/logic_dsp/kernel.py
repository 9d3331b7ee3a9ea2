"""Bind and launch the hand-written CUDA gate-program executor.

The kernel lives in ``repro_torch/csrc/logic_dsp.cu``: ``mega_kernel``
replaces the Pallas ``_mega_kernel`` / ``mega_pallas_call`` (K2) and, as
its one-stage case, ``_logic_kernel`` / ``logic_pallas_call`` (K1), both in
``src/repro/kernels/logic_dsp/kernel.py``.  ``repro_torch.kernels.native``
builds it with the port's other CUDA sources into one library at first use
and binds it; its ``build``, ``build_info``, ``library`` and launch
counters are re-exported here.

The wrappers take CUDA tensors only, allocate the output and the scratch
with ``torch.empty``, launch on the current stream without synchronising,
raise on a launch error, and count their launches.  The scratch is freed
when a wrapper returns, possibly before its kernel ends; the caching
allocator hands it out again only to work queued later on the same stream.  The plain PyTorch
versions are in ``ref.py``; ``ops.py`` picks between them by device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.native import (build, build_dir, build_info,
                                        count_launch, launch_count, library,
                                        raise_on, reset_launch_counts)

__all__ = ["build", "build_dir", "build_info", "cols_per_block",
           "launch_count", "library", "logic_cuda_call", "mega_cuda_call",
           "reset_launch_counts"]

#: Word columns each block owns.  A block's steps are latency-bound, so its
#: time grows with its columns from 2 up (an H100 sweep over 1..32 at the
#: LeNet-5 fc1 shape); the block count grows with the batch instead.
COLS_PER_BLOCK = 2
#: Largest dynamic shared memory a block may take on Hopper (227 KB).
MAX_SMEM = 232_448


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def cols_per_block(n_unit: int) -> int:
    """Word columns a block owns: ``COLS_PER_BLOCK``, narrowed to one when
    a step's results would not fit a block's shared memory."""
    for bw in (COLS_PER_BLOCK, 1):
        if n_unit * bw * 4 <= MAX_SMEM:
            return bw
    raise ValueError(f"n_unit={n_unit} needs more shared memory than a "
                     "Hopper block has")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _check(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                             f"{t.device} (the kernel takes no CPU tensor)")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(kind: str, src_a, src_b, dst, opcode, step_branch,
            input_words, stage_table, out_addrs, out_rows, *, n_addr: int,
            n_outputs: int, chain: bool, handoff_rows: int) -> torch.Tensor:
    """Allocate the output, scratch and chain hand-off, launch
    ``mega_kernel`` once and count it under ``kind``; a batch of zero words
    launches nothing."""
    device = input_words.device
    n_unit = src_a.shape[1]
    w = input_words.shape[1]
    out = torch.empty((n_outputs, w), dtype=torch.int32, device=device)
    if w == 0:
        return out
    bw = cols_per_block(n_unit)
    scratch = torch.empty((n_addr, w), dtype=torch.int32, device=device)
    handoff = (torch.empty((handoff_rows, w), dtype=torch.int32,
                           device=device)
               if chain and handoff_rows else None)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.logic_dsp_mega(
            _ptr(src_a), _ptr(src_b), _ptr(dst), _ptr(opcode),
            _ptr(step_branch), _ptr(stage_table), stage_table.shape[0],
            int(chain), n_unit, _ptr(input_words), _ptr(out_addrs),
            _ptr(out_rows), _ptr(scratch), _ptr(handoff), _ptr(out), w, bw,
            stream)
    raise_on(err, "mega_kernel")
    count_launch(kind)
    return out


#: One-row stage tables of K1 launches, per (n_steps, n_in, n_out, device).
_single_stage: dict[tuple, torch.Tensor] = {}


def logic_cuda_call(src_a, src_b, dst, opcode, step_branch, input_words,
                    output_addrs, *, n_addr: int) -> torch.Tensor:
    """Launch K1: ``(n_inputs, W)`` int32 words -> ``(n_outputs, W)``.

    Streams are ``(n_steps, n_unit)`` int32 (any ``n_unit``; zero steps run
    no step loop), ``step_branch`` is ``(n_steps,)`` and ``output_addrs``
    ``(n_outputs,)``; every address must lie in ``[0, n_addr)``, which the
    ``ops`` layer checks once per program.  The launch is ``mega_kernel``
    with the one stage ``(0, n_steps, n_inputs, n_outputs, 0)``.
    """
    device = input_words.device
    _check(device, src_a=src_a, src_b=src_b, dst=dst, opcode=opcode,
           step_branch=step_branch, input_words=input_words,
           output_addrs=output_addrs)
    n_steps = src_a.shape[0]
    if not (src_b.shape == dst.shape == opcode.shape == src_a.shape and
            step_branch.shape == (n_steps,) and output_addrs.dim() == 1):
        raise ValueError("stream shapes disagree")
    n_inputs = input_words.shape[0]
    n_outputs = output_addrs.shape[0]
    if n_addr < 2 + n_inputs:
        raise ValueError(f"n_addr={n_addr} cannot hold {n_inputs} inputs")
    key = (n_steps, n_inputs, n_outputs, str(device))
    if key not in _single_stage:
        _single_stage[key] = torch.tensor(
            [[0, n_steps, n_inputs, n_outputs, 0]], dtype=torch.int32,
            device=device)
    return _launch("logic", src_a, src_b, dst, opcode, step_branch,
                   input_words, _single_stage[key], output_addrs, None,
                   n_addr=n_addr, n_outputs=n_outputs, chain=True,
                   handoff_rows=0)


def mega_cuda_call(src_a, src_b, dst, opcode, step_branch, input_words,
                   stage_table, out_addrs, out_rows, *, n_addr: int,
                   n_outputs: int, chain: bool,
                   handoff_rows: int) -> torch.Tensor:
    """Launch K2: the whole stage pipeline in one launch.

    ``stage_table`` is ``(n_stages, 5)`` int32 rows ``(step_lo, step_hi,
    n_in, n_out, out_lo)`` into the concatenated ``(total_steps, n_unit)``
    streams and the flat ``out_addrs``.  ``out_rows`` maps each flat stage
    output to its row of the result (the inverse of the output
    permutation; parallel mode only).  ``handoff_rows`` sizes the chain
    mode's stage-to-stage buffer (the widest non-final stage output).
    """
    device = input_words.device
    _check(device, src_a=src_a, src_b=src_b, dst=dst, opcode=opcode,
           step_branch=step_branch, input_words=input_words,
           stage_table=stage_table, out_addrs=out_addrs, out_rows=out_rows)
    total_steps = src_a.shape[0]
    if not (src_b.shape == dst.shape == opcode.shape == src_a.shape and
            step_branch.shape == (total_steps,) and
            stage_table.dim() == 2 and stage_table.shape[1] == 5 and
            stage_table.shape[0] >= 1 and out_addrs.dim() == 1 and
            (chain or out_rows.shape == out_addrs.shape)):
        raise ValueError("stream or stage-table shapes disagree")
    return _launch("mega", src_a, src_b, dst, opcode, step_branch,
                   input_words, stage_table, out_addrs, out_rows,
                   n_addr=n_addr, n_outputs=n_outputs, chain=chain,
                   handoff_rows=handoff_rows)
