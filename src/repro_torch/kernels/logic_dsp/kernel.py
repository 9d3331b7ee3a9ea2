"""Bind and launch the hand-written CUDA gate-program executor.

The kernel lives in ``repro_torch/csrc/logic_dsp.cu``: ``mega_kernel``
replaces the Pallas ``_mega_kernel`` / ``mega_pallas_call`` (K2) and, as
its one-stage case, ``_logic_kernel`` / ``logic_pallas_call`` (K1), both in
``src/repro/kernels/logic_dsp/kernel.py``.  ``repro_torch.kernels.native``
builds it with the port's other CUDA sources into one library at first use
and binds it; its ``build``, ``build_info``, ``library`` and launch
counters are re-exported here.

The kernel comes in two variants, picked by :func:`plan_launch` from the
program's size alone: ``"shared"`` keeps the scratch in a block's shared
memory, ``"device"`` in a device buffer for programs too large for it.
The kernel reads one index record per lane and step (``ops`` builds them
once per program, 8 bytes for the shared variant, 16 for the device one).
Launches are counted per kernel (``"logic"`` = K1, ``"mega"`` = K2) and per
variant: ``launch_count("mega", "shared")``.

Beside it, ``csrc/bitpack.cu`` lays a wave out for it and back:
:func:`pack_cuda_call` packs a ``(batch, n)`` bool slab into ``(n, W)``
int32 words and :func:`unpack_cuda_call` unpacks them (counted as
``"pack"`` and ``"unpack"``); their plain versions are ``ref.pack_bits_ref``
and ``ref.unpack_bits_ref``.

The wrappers take CUDA tensors only, allocate the output and the scratch
with ``torch.empty``, launch on the current stream without synchronising,
raise on a launch error, and count their launches.  The scratch is freed
when a wrapper returns, possibly before its kernel ends; the caching
allocator hands it out again only to work queued later on the same stream.
The plain PyTorch versions are in ``ref.py``; ``ops.py`` picks between
them by device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.packing import WORD_BITS
from repro_torch.kernels.native import (KERNELS, build, build_dir,
                                        build_info, count_launch,
                                        launch_count, library, raise_on,
                                        reset_launch_counts)

__all__ = ["KERNELS", "LaunchPlan", "build", "build_dir", "build_info",
           "launch_count", "library", "logic_cuda_call", "mega_cuda_call",
           "pack_cuda_call", "plan_launch", "reset_launch_counts",
           "unpack_cuda_call"]

#: Word columns a block owns, at most (1 where 2 do not fit).  A block's
#: steps are latency-bound, so its time hardly grows with its columns,
#: while the records it reads are shared by them; an H100 sweep over 1, 2
#: and 4 at the LeNet-5 fc1 shapes picked 2 (PERF.md).
COLS_PER_BLOCK = 2
#: Largest dynamic shared memory a block may take on Hopper (227 KB).
MAX_SMEM = 232_448
#: Step slots of the record ring, tried in this order (0: no ring).
RING_SLOTS = (4, 2, 0)
#: The shared variant's 8-byte records hold rows below this.
NARROW_ROWS = 1 << 16
RECORD_BYTES = {"shared": 8, "device": 16}
MAX_THREADS = 1024


@dataclass(frozen=True)
class LaunchPlan:
    """How one program runs: where its scratch lives, the columns a block
    owns, the record ring's slots, whether a step needs one barrier or two,
    the threads a block runs and the dynamic shared memory it takes.  The
    launch uses ``threads`` and ``smem_bytes`` as they are."""
    scratch: str        # "shared" or "device"
    cols: int
    ring: int
    one_barrier: bool
    smem_bytes: int
    threads: int


def threads(scratch: str, n_unit: int, cols: int) -> int:
    """Threads a block runs, at most 1024: one per lane (shared: a thread
    runs all of a lane's columns), or per lane and column (device)."""
    n = n_unit if scratch == "shared" else n_unit * cols
    return min(MAX_THREADS, max(32, -(-n // 32) * 32))


def smem_bytes(scratch: str, n_unit: int, cols: int, n_addr: int,
               ring: int, one_barrier: bool) -> int:
    """Dynamic shared memory of one launch: the record ring, the scratch
    when it is shared, and the step results when a step takes two
    barriers."""
    total = ring * n_unit * RECORD_BYTES[scratch]
    if scratch == "shared":
        total += n_addr * cols * 4
    if not one_barrier:
        total += n_unit * cols * 4
    return total


def plan_launch(n_addr: int, n_unit: int, one_barrier: bool,
                scratch: str | None = None) -> LaunchPlan:
    """The variant a program of ``n_addr`` rows and ``n_unit`` lanes takes:
    the shared-memory scratch whenever it fits a block, else the
    device-memory one; the deepest record ring that fits, then the most
    columns up to ``COLS_PER_BLOCK``.  ``scratch`` pins the variant (the
    card tests).  Raises when nothing fits a block."""
    widths = [COLS_PER_BLOCK >> i
              for i in range(COLS_PER_BLOCK.bit_length())]
    variants = ("shared", "device")
    if scratch is not None:
        variants = tuple(v for v in variants if v == scratch)
    for scratch in variants:
        # the shared variant always reads its records from a ring
        for ring in RING_SLOTS if scratch == "device" else RING_SLOTS[:-1]:
            for bw in widths:
                smem = smem_bytes(scratch, n_unit, bw, n_addr, ring,
                                  one_barrier)
                if smem <= MAX_SMEM and (scratch == "device" or
                                         n_addr <= NARROW_ROWS):
                    return LaunchPlan(scratch, bw, ring, one_barrier, smem,
                                      threads(scratch, n_unit, bw))
    raise ValueError(f"n_unit={n_unit}, n_addr={n_addr} need more shared "
                     "memory than a Hopper block has")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _check(device: torch.device, dtype: torch.dtype = torch.int32,
           **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                             f"{t.device} (the kernel takes no CPU tensor)")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(kind: str, rec, input_words, stage_table, out_addrs, out_rows,
            *, plan: LaunchPlan, n_addr: int, n_outputs: int, chain: bool,
            handoff_rows: int) -> torch.Tensor:
    """Allocate the output, the device scratch (device variant) and the
    chain hand-off, launch ``mega_kernel`` once and count it under
    ``kind`` and the plan's variant; a batch of zero words launches
    nothing."""
    device = input_words.device
    if rec.dim() != 3 or rec.shape[2] != RECORD_BYTES[plan.scratch] // 4:
        raise ValueError(f"records of shape {tuple(rec.shape)} do not fit "
                         f"the {plan.scratch} variant")
    n_unit = rec.shape[1]
    if plan.scratch == "shared" and n_addr > NARROW_ROWS:
        raise ValueError(f"n_addr={n_addr} does not fit the shared variant")
    w = input_words.shape[1]
    out = torch.empty((n_outputs, w), dtype=torch.int32, device=device)
    if w == 0:
        return out
    scratch = (torch.empty((n_addr, w), dtype=torch.int32, device=device)
               if plan.scratch == "device" else None)
    handoff = (torch.empty((handoff_rows, w), dtype=torch.int32,
                           device=device)
               if chain and handoff_rows else None)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.logic_dsp_mega(
            _ptr(rec), rec.shape[0], _ptr(stage_table), stage_table.shape[0],
            int(chain), n_unit, _ptr(input_words), _ptr(out_addrs),
            _ptr(out_rows), _ptr(scratch), _ptr(handoff), _ptr(out), w,
            plan.cols.bit_length() - 1, n_addr,
            int(plan.scratch == "shared"), plan.ring, int(plan.one_barrier),
            plan.threads, plan.smem_bytes, stream)
    raise_on(err, "mega_kernel")
    count_launch(kind, plan.scratch)
    return out


#: One-row stage tables of K1 launches, per (n_steps, n_in, n_out, device).
_single_stage: dict[tuple, torch.Tensor] = {}


def logic_cuda_call(rec, input_words, output_addrs, *, n_addr: int,
                    plan: LaunchPlan) -> torch.Tensor:
    """Launch K1: ``(n_inputs, W)`` int32 words -> ``(n_outputs, W)``.

    ``rec`` is the program's ``(n_steps, n_unit, 2 or 4)`` int32 records
    (``ops.launch_records``; zero steps run no step loop), ``plan`` its
    :func:`plan_launch`, ``output_addrs`` ``(n_outputs,)``; every address
    must lie in ``[0, n_addr)``, which the ``ops`` layer checks once per
    program.  The launch is ``mega_kernel`` with the one stage
    ``(0, n_steps, n_inputs, n_outputs, 0)``.
    """
    device = input_words.device
    _check(device, rec=rec, input_words=input_words,
           output_addrs=output_addrs)
    if output_addrs.dim() != 1:
        raise ValueError("output_addrs must be 1-D")
    n_steps = rec.shape[0]
    n_inputs = input_words.shape[0]
    n_outputs = output_addrs.shape[0]
    if n_addr < 2 + n_inputs:
        raise ValueError(f"n_addr={n_addr} cannot hold {n_inputs} inputs")
    key = (n_steps, n_inputs, n_outputs, str(device))
    if key not in _single_stage:
        _single_stage[key] = torch.tensor(
            [[0, n_steps, n_inputs, n_outputs, 0]], dtype=torch.int32,
            device=device)
    return _launch("logic", rec, input_words, _single_stage[key],
                   output_addrs, None, plan=plan, n_addr=n_addr,
                   n_outputs=n_outputs, chain=True, handoff_rows=0)


def mega_cuda_call(rec, input_words, stage_table, out_addrs, out_rows, *,
                   n_addr: int, n_outputs: int, chain: bool,
                   handoff_rows: int, plan: LaunchPlan) -> torch.Tensor:
    """Launch K2: the whole stage pipeline in one launch.

    ``rec`` holds the records of the concatenated ``(total_steps,
    n_unit)`` streams, ``stage_table`` is ``(n_stages, 5)`` int32 rows
    ``(step_lo, step_hi, n_in, n_out, out_lo)`` into them and into the flat
    ``out_addrs``.  ``out_rows`` maps each flat stage output to its row of
    the result (the inverse of the output permutation; parallel mode
    only).  ``handoff_rows`` sizes the chain mode's stage-to-stage buffer
    (the widest non-final stage output).
    """
    device = input_words.device
    _check(device, rec=rec, input_words=input_words,
           stage_table=stage_table, out_addrs=out_addrs, out_rows=out_rows)
    if not (stage_table.dim() == 2 and stage_table.shape[1] == 5 and
            stage_table.shape[0] >= 1 and out_addrs.dim() == 1 and
            (chain or out_rows.shape == out_addrs.shape)):
        raise ValueError("stream or stage-table shapes disagree")
    return _launch("mega", rec, input_words, stage_table, out_addrs,
                   out_rows, plan=plan, n_addr=n_addr, n_outputs=n_outputs,
                   chain=chain, handoff_rows=handoff_rows)


def _on_current_stream(device: torch.device, launcher, *args) -> int:
    """Call a C launcher with ``args`` and ``device``'s current stream,
    ``device`` made current only where it is not already (the wave's pack
    and unpack sit on the runner's critical path, so their wrappers skip
    the device context and the ``Stream`` object that ``_launch`` makes)."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return launcher(*args, stream)
    with torch.cuda.device(device):
        return launcher(*args, stream)


def pack_cuda_call(bits: torch.Tensor) -> torch.Tensor:
    """Launch the pack kernel: ``(batch, n)`` bool -> ``(n, ceil(batch /
    32))`` int32, sample ``32 * j + k`` at bit ``k`` of word ``j``, the pad
    samples of a ragged last word zero bits.  A non-contiguous ``bits``
    (such as a transposed view) is copied contiguous first; an empty
    result launches nothing."""
    bits = bits.contiguous()
    device = bits.device
    _check(device, torch.bool, bits=bits)
    batch, n = bits.shape
    w = -(-batch // WORD_BITS)
    out = torch.empty((n, w), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    err = _on_current_stream(device, library().bitpack_pack,
                             bits.data_ptr(), batch, n, out.data_ptr(), w)
    raise_on(err, "pack_kernel")
    count_launch("pack")
    return out


def unpack_cuda_call(words: torch.Tensor, batch: int) -> torch.Tensor:
    """Launch the unpack kernel: ``(n, W)`` int32 -> ``(batch, n)`` bool,
    bit ``k`` of word ``j`` to sample ``32 * j + k``; ``batch`` must lie in
    ``[0, 32 * W]``; non-contiguous ``words`` are copied contiguous first.
    An empty result launches nothing."""
    words = words.contiguous()
    device = words.device
    _check(device, words=words)
    n, w = words.shape
    if not 0 <= batch <= WORD_BITS * w:
        raise ValueError(f"batch={batch} outside [0, {WORD_BITS * w}] for "
                         f"{w} words")
    out = torch.empty((batch, n), dtype=torch.bool, device=device)
    if out.numel() == 0:
        return out
    err = _on_current_stream(device, library().bitpack_unpack,
                             words.data_ptr(), n, w, out.data_ptr(), batch)
    raise_on(err, "unpack_kernel")
    count_launch("unpack")
    return out
