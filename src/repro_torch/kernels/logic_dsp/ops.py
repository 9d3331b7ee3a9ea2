"""Public API over the logic_dsp kernels: bit packing, program streams as
device tensors, and the word- and bit-level executors.

Port of ``src/repro/kernels/logic_dsp/ops.py``.  Each executor runs the
CUDA kernel (``kernel.py``) on a CUDA tensor and the plain PyTorch version
(``ref.py``) on a CPU tensor; ``use_ref=True`` asks for the plain version
on either device.  A CUDA tensor never falls back to the plain version.
The bit-level entry points (:func:`logic_infer_bits`,
:func:`mega_infer_bits`) run on ``device="cuda"`` unless told otherwise and
raise when no CUDA device is present; ``device="cpu"`` is the explicit
opt-in to the CPU.

PyTorch runs eagerly, so there is no runner trace to cache: the per-program
state is the stream tensors, memoized on the (frozen) program object per
device.  The kernel takes any ``n_unit``, so the lanes are not padded.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scheduler import LogicProgram, MegaProgram
from repro_torch.kernels.logic_dsp import kernel as _k
from repro_torch.kernels.logic_dsp.ref import (logic_forward_ref,
                                               mega_forward_ref)

WORD_BITS = 32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch executors on the CPU instead")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# bit packing (LSB-first, the words of core/packing.py)
# ---------------------------------------------------------------------------

def _bit_weights(device) -> torch.Tensor:
    """(32,) int32 ``1 << k``; bit 31 is the int32 sign bit, -2**31."""
    return torch.tensor([1 << k for k in range(WORD_BITS - 1)] + [-2 ** 31],
                        dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(batch, n) bool -> (n, ceil(batch/32)) int32, sample 32*j+k at bit k
    of word j.  The int32 sum cannot overflow: the weights are distinct
    powers of two and only bit 31's is negative."""
    batch, n = bits.shape
    w = -(-batch // WORD_BITS)
    b = torch.zeros((w * WORD_BITS, n), dtype=torch.int32,
                    device=bits.device)
    b[:batch] = bits
    chunks = b.view(w, WORD_BITS, n) * _bit_weights(bits.device)[:, None]
    return chunks.sum(dim=1, dtype=torch.int32).T.contiguous()


def unpack_bits(words: torch.Tensor, batch: int) -> torch.Tensor:
    """(n, W) int32 -> (batch, n) bool.  The arithmetic ``>>`` sign-extends
    bit 31, and ``& 1`` keeps only the shifted bit."""
    n, w = words.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(n, w * WORD_BITS)[:, :batch].T.to(torch.bool) \
        .contiguous()


def _bits_tensor(bits, device: torch.device) -> torch.Tensor:
    if isinstance(bits, torch.Tensor):
        return bits.to(device=device, dtype=torch.bool)
    return torch.from_numpy(np.ascontiguousarray(bits, dtype=bool)).to(device)


# ---------------------------------------------------------------------------
# program streams as device tensors
# ---------------------------------------------------------------------------

def _memo(obj) -> dict:
    memo = getattr(obj, "_torch_arrays", None)
    if memo is None:
        memo = {}
        object.__setattr__(obj, "_torch_arrays", memo)
    return memo


def _check_addresses(n_addr: int, **arrays: np.ndarray) -> None:
    """The kernels index the scratch without bounds checks: refuse a
    stream that addresses a row outside ``[0, n_addr)``."""
    for name, a in arrays.items():
        if a.size and (a.min() < 0 or a.max() >= n_addr):
            raise ValueError(f"{name} addresses a row outside "
                             f"[0, {n_addr})")


def _check_rows(words: torch.Tensor, n_inputs: int) -> None:
    if words.dim() != 2 or words.shape[0] != n_inputs:
        raise ValueError(f"input words must be ({n_inputs}, W), got "
                         f"{tuple(words.shape)}")


def program_arrays(prog: LogicProgram, device=None) -> dict:
    """The program's streams as int32 tensors on ``device`` (CUDA unless
    told otherwise), memoized on the program object per device."""
    dev = resolve_device(device)
    memo = _memo(prog)
    key = str(dev)
    if key not in memo:
        host = {k: np.ascontiguousarray(getattr(prog, k), dtype=np.int32)
                for k in ("src_a", "src_b", "dst", "opcode", "step_branch",
                          "output_addrs")}
        _check_addresses(prog.n_addr, src_a=host["src_a"],
                         src_b=host["src_b"], dst=host["dst"],
                         output_addrs=host["output_addrs"])
        arrs = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        arrs["n_addr"] = prog.n_addr
        memo[key] = arrs
    return memo[key]


def mega_arrays(mega: MegaProgram, device=None) -> dict:
    """The MegaProgram's concatenated streams and stage table as int32
    tensors on ``device``, memoized on the mega object per device.
    ``out_rows`` is the inverse output permutation, so the kernel writes
    each stage output straight to its final row."""
    dev = resolve_device(device)
    memo = _memo(mega)
    key = str(dev)
    if key not in memo:
        perm = np.asarray(mega.output_perm, dtype=np.int64)
        out_rows = np.empty(len(perm), dtype=np.int32)
        out_rows[perm] = np.arange(len(perm), dtype=np.int32)
        meta = np.asarray(mega.stage_meta, dtype=np.int32).reshape(-1, 5)
        host = {k: np.ascontiguousarray(getattr(mega, k), dtype=np.int32)
                for k in ("src_a", "src_b", "dst", "opcode", "step_branch",
                          "out_addrs")}
        host.update(perm=perm.astype(np.int32), out_rows=out_rows,
                    stage_table=np.ascontiguousarray(meta))
        _check_addresses(mega.n_addr, src_a=host["src_a"],
                         src_b=host["src_b"], dst=host["dst"],
                         out_addrs=host["out_addrs"])
        if (2 + meta[:, 2]).max() > mega.n_addr:
            raise ValueError("a stage's inputs do not fit the scratch rows")
        arrs = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        arrs["n_addr"] = mega.n_addr
        # widest stage output handed to a next stage (chain mode)
        arrs["handoff_rows"] = int(meta[:-1, 3].max()) if len(meta) > 1 else 0
        memo[key] = arrs
    return memo[key]


# ---------------------------------------------------------------------------
# single-program execution (K1)
# ---------------------------------------------------------------------------

def forward_words(src_a, src_b, dst, opcode, step_branch, output_addrs,
                  words: torch.Tensor, *, n_addr: int,
                  use_ref: bool = False) -> torch.Tensor:
    """Word-level program execution: (n_inputs, W) -> (n_outputs, W) int32.

    The CUDA kernel for a CUDA tensor (gateless programs included: it runs
    no step loop and still gathers the outputs), the plain version for a
    CPU tensor or when ``use_ref`` asks for it."""
    if use_ref or words.device.type == "cpu":
        return logic_forward_ref(src_a, src_b, dst, opcode, words,
                                 output_addrs, n_addr,
                                 step_branch=step_branch)
    return _k.logic_cuda_call(src_a, src_b, dst, opcode, step_branch, words,
                              output_addrs, n_addr=n_addr)


def logic_forward(prog: LogicProgram, input_words: torch.Tensor,
                  use_ref: bool = False) -> torch.Tensor:
    """Packed-word forward on ``input_words``' device:
    (n_inputs, W) int32 -> (n_outputs, W) int32."""
    _check_rows(input_words, prog.n_inputs)
    arrs = program_arrays(prog, input_words.device)
    return forward_words(
        arrs["src_a"], arrs["src_b"], arrs["dst"], arrs["opcode"],
        arrs["step_branch"], arrs["output_addrs"], input_words,
        n_addr=arrs["n_addr"], use_ref=use_ref)


def logic_infer_bits(prog: LogicProgram, bits, device=None,
                     use_ref: bool = False) -> np.ndarray:
    """Boolean convenience wrapper: (batch, n_inputs) -> (batch, n_outputs)
    numpy bool, packed, executed and unpacked on ``device``."""
    dev = resolve_device(device)
    x = _bits_tensor(bits, dev)
    out = logic_forward(prog, pack_bits(x), use_ref=use_ref)
    return unpack_bits(out, x.shape[0]).cpu().numpy()


# ---------------------------------------------------------------------------
# megaprogram execution (K2: single-launch pipelines)
# ---------------------------------------------------------------------------

def mega_forward_words(mega: MegaProgram, words: torch.Tensor, *,
                       use_ref: bool = False) -> torch.Tensor:
    """Word-level mega execution: (n_inputs, W) -> (n_outputs, W) int32 in
    ONE kernel launch on a CUDA tensor (a pipeline with no gates at all
    included), or the plain stage walk on the CPU / with ``use_ref``."""
    _check_rows(words, mega.n_inputs)
    arrs = mega_arrays(mega, words.device)
    if use_ref or words.device.type == "cpu":
        return mega_forward_ref(mega, arrs, words)
    return _k.mega_cuda_call(
        arrs["src_a"], arrs["src_b"], arrs["dst"], arrs["opcode"],
        arrs["step_branch"], words, arrs["stage_table"], arrs["out_addrs"],
        arrs["out_rows"], n_addr=mega.n_addr, n_outputs=mega.n_outputs,
        chain=(mega.mode == "chain"), handoff_rows=arrs["handoff_rows"])


def mega_infer_bits(mega: MegaProgram, bits, device=None,
                    use_ref: bool = False) -> np.ndarray:
    """Boolean convenience wrapper over the mega kernel:
    (batch, n_inputs) -> (batch, n_outputs) in one launch."""
    dev = resolve_device(device)
    x = _bits_tensor(bits, dev)
    out = mega_forward_words(mega, pack_bits(x), use_ref=use_ref)
    return unpack_bits(out, x.shape[0]).cpu().numpy()
