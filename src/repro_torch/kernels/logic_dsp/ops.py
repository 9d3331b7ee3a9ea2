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
device, beside what the CUDA kernel reads instead (:func:`launch_records`:
one index record per lane and step, and the launch plan: scratch variant,
columns per block, record ring, and whether a step needs one barrier or
two).  The kernel takes any ``n_unit``, so the lanes are not padded.
:func:`phased_infer_bits` is the calibration's measurement path: one
inference split into pack / setup / kernel / unpack, fenced on the card.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import calibrate as _calibrate
from repro_torch.core.gate_ir import MIXED_DISPATCH
from repro_torch.core.scheduler import LogicProgram, MegaProgram
from repro_torch.kernels.logic_dsp import kernel as _k
from repro_torch.kernels.logic_dsp.ref import (TRUTH_TABLES,
                                               logic_forward_ref,
                                               mega_forward_ref)

WORD_BITS = 32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU.  Raises when CUDA is asked for (or defaulted to) and absent,
    except under a ``FakeTensorMode``, whose tensors have no storage."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        from torch._guards import detect_fake_mode
        if detect_fake_mode() is not None:
            # fake tensors (the dry run) hold no storage: no card needed
            return dev if dev.index is not None else torch.device("cuda", 0)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch executors on the CPU instead")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: The calibration record each device type's wall-clock fit is saved and
#: loaded under.  The reference's ``"default"`` record holds a TPU's or a
#: JAX-on-CPU fit, which says nothing about this port's phases.
CALIBRATION_NAMES = {"cuda": "torch-cuda", "cpu": "torch-cpu"}


def calibration_name(device=None) -> str:
    """The calibration record for ``device`` (CUDA unless the caller names
    the CPU): ``"torch-cuda"`` or ``"torch-cpu"``."""
    return CALIBRATION_NAMES[resolve_device(device).type]


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


def _effective_ops(opcode: np.ndarray,
                   step_branch: np.ndarray) -> np.ndarray:
    """Each lane's op: the step's bank for a homogeneous step (padding
    lanes included), the lane's own opcode for a mixed one."""
    branch = np.asarray(step_branch, dtype=np.int64)[:, None]
    return np.where(branch < MIXED_DISPATCH, branch,
                    np.asarray(opcode, dtype=np.int64))


def same_step_reads_free(src_a, src_b, dst, opcode, step_branch,
                         trash=None) -> bool:
    """True when no step reads a row that the same step writes, counting
    only reads that matter: a lane that writes its step's ``trash`` row (a
    scalar, or one per step; None counts every lane) has no reads that
    matter, NOP reads nothing, NOT and COPY only ``src_a``.  Such a
    program's writes of a step cannot clobber its reads, so the CUDA kernel
    runs each step with one barrier instead of two.  A program that reads
    its trash row where it matters is refused too, since padding lanes
    write it.  Liveness allocation frees a row at its last reader's step
    + 1, so compiled programs pass; the check does not rely on that."""
    src_a, src_b, dst = (np.asarray(x, dtype=np.int64)
                         for x in (src_a, src_b, dst))
    n_steps = src_a.shape[0]
    if n_steps == 0:
        return True
    op = _effective_ops(opcode, step_branch)
    live = np.ones(dst.shape, dtype=bool)
    if trash is not None:
        trash_s = np.broadcast_to(np.asarray(trash, dtype=np.int64),
                                  (n_steps,))[:, None]
        live = dst != trash_s
    reads_a = live & (op != 0)
    reads_b = live & (op >= 1) & (op <= 6)
    step = np.broadcast_to(np.arange(n_steps, dtype=np.int64)[:, None],
                           src_a.shape)
    span = int(max(src_a.max(), src_b.max(), dst.max())) + 1
    read_keys = np.concatenate([step[reads_a] * span + src_a[reads_a],
                                step[reads_b] * span + src_b[reads_b]])
    if np.isin(read_keys, step * span + dst).any():
        return False
    if trash is not None:
        return not ((src_a == trash_s) & reads_a).any() and \
            not ((src_b == trash_s) & reads_b).any()
    return True


def bank_order(src_a, src_b, dst, cols: int) -> np.ndarray:
    """A lane order for each step, ``(n_steps, n_unit)``, that spreads the
    rows each shared-memory wavefront touches over the banks: with rows of
    ``cols`` words, the ``32 // cols`` lanes of a wavefront hit bank group
    ``row % (32 // cols)``, and a greedy pass (all steps at once, one lane
    at a time) puts each lane in the wavefront where its three rows
    (``src_a``, ``src_b``, ``dst``) collide least.  Lanes of a step are
    independent, so any order computes the same words."""
    src_a, src_b, dst = (np.asarray(x, dtype=np.int64)
                         for x in (src_a, src_b, dst))
    n_steps, n = src_a.shape
    width = 32 // cols                    # lanes a wavefront serves
    groups = -(-n // width)
    cap = np.full(groups, width)
    cap[-1] = n - (groups - 1) * width
    keys = np.stack([src_a % width, src_b % width, dst % width])
    hits = np.zeros((3, n_steps, groups, width), dtype=np.int64)
    size = np.zeros((n_steps, groups), dtype=np.int64)
    slot = np.empty((n_steps, n), dtype=np.int64)
    steps = np.arange(n_steps)
    for lane in range(n):
        k = keys[:, :, lane]
        cost = sum(hits[j, steps, :, k[j]] for j in range(3))
        cost = np.where(size < cap, cost * (n + 1) + size, np.iinfo(
            np.int64).max)
        g = cost.argmin(axis=1)
        for j in range(3):
            hits[j, steps, g, k[j]] += 1
        slot[:, lane] = g * width + size[steps, g]
        size[steps, g] += 1
    order = np.empty((n_steps, n), dtype=np.int64)
    order[steps[:, None], slot] = np.arange(n)
    return order


def launch_records(src_a, src_b, dst, opcode, step_branch, *, n_addr: int,
                   trash=None, device=None, scratch: str | None = None,
                   two_barriers: bool = False) -> dict:
    """What the CUDA kernel reads for a program's host streams: its launch
    plan (``kernel.plan_launch`` over ``n_addr``, ``n_unit`` and
    :func:`same_step_reads_free`) and ``rec``, one int32 record per lane
    and step on ``device``: ``(src_a | src_b << 16, dst | tt << 16)`` for
    the shared variant (rows below 2**16), ``(src_a, src_b, dst, tt)`` for
    the device one, ``tt`` the lane's op as its truth table
    (``ref.TRUTH_TABLES``); the shared variant's lanes in
    :func:`bank_order`.  The streams stay as they are.  ``scratch``
    pins the variant and ``two_barriers`` skips the proof (for the card
    tests)."""
    src_a, src_b, dst = (np.asarray(x, dtype=np.int64)
                         for x in (src_a, src_b, dst))
    one_barrier = not two_barriers and same_step_reads_free(
        src_a, src_b, dst, opcode, step_branch, trash)
    plan = _k.plan_launch(n_addr, src_a.shape[1], one_barrier,
                          scratch=scratch)
    op = _effective_ops(opcode, step_branch)
    table = np.zeros(16, dtype=np.int64)      # unknown opcodes act as NOP
    table[:len(TRUTH_TABLES)] = TRUTH_TABLES
    tt = table[np.clip(op, 0, 15)]
    if plan.scratch == "shared":
        if src_a.size:
            order = bank_order(src_a, src_b, dst, plan.cols)
            src_a, src_b, dst, tt = (np.take_along_axis(x, order, axis=1)
                                     for x in (src_a, src_b, dst, tt))
        rec = np.stack([src_a | src_b << 16, dst | tt << 16], axis=-1)
        rec = rec.astype(np.uint32).view(np.int32)
    else:
        rec = np.stack([src_a, src_b, dst, tt], axis=-1).astype(np.int32)
    return {"rec": torch.from_numpy(np.ascontiguousarray(rec)).to(device),
            "plan": plan}


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
        arrs.update(launch_records(
            host["src_a"], host["src_b"], host["dst"], host["opcode"],
            host["step_branch"], n_addr=prog.n_addr, trash=prog.trash_addr,
            device=dev))
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
        arrs.update(launch_records(
            host["src_a"], host["src_b"], host["dst"], host["opcode"],
            host["step_branch"], n_addr=mega.n_addr, trash=mega.step_trash,
            device=dev))
        # widest stage output handed to a next stage (chain mode)
        arrs["handoff_rows"] = int(meta[:-1, 3].max()) if len(meta) > 1 else 0
        memo[key] = arrs
    return memo[key]


# ---------------------------------------------------------------------------
# single-program execution (K1)
# ---------------------------------------------------------------------------

def forward_words(src_a, src_b, dst, opcode, step_branch, output_addrs,
                  words: torch.Tensor, *, n_addr: int,
                  use_ref: bool = False,
                  launch: dict | None = None) -> torch.Tensor:
    """Word-level program execution: (n_inputs, W) -> (n_outputs, W) int32.

    The CUDA kernel for a CUDA tensor (gateless programs included: it runs
    no step loop and still gathers the outputs), the plain version for a
    CPU tensor or when ``use_ref`` asks for it.  The kernel needs
    ``launch``, the program's ``rec`` and ``plan``, built once per program
    (``program_arrays`` holds them; :func:`launch_records` builds them for
    streams of no program); the plain version does not read it."""
    if use_ref or words.device.type == "cpu":
        return logic_forward_ref(src_a, src_b, dst, opcode, words,
                                 output_addrs, n_addr,
                                 step_branch=step_branch)
    if launch is None:
        raise ValueError("the CUDA kernel needs launch= (program_arrays or "
                         "launch_records), built once per program")
    return _k.logic_cuda_call(launch["rec"], words, output_addrs,
                              n_addr=n_addr, plan=launch["plan"])


def logic_forward(prog: LogicProgram, input_words: torch.Tensor,
                  use_ref: bool = False) -> torch.Tensor:
    """Packed-word forward on ``input_words``' device:
    (n_inputs, W) int32 -> (n_outputs, W) int32."""
    _check_rows(input_words, prog.n_inputs)
    arrs = program_arrays(prog, input_words.device)
    return forward_words(
        arrs["src_a"], arrs["src_b"], arrs["dst"], arrs["opcode"],
        arrs["step_branch"], arrs["output_addrs"], input_words,
        n_addr=arrs["n_addr"], use_ref=use_ref, launch=arrs)


def logic_infer_bits(prog: LogicProgram, bits, device=None,
                     use_ref: bool = False) -> np.ndarray:
    """Boolean convenience wrapper: (batch, n_inputs) -> (batch, n_outputs)
    numpy bool, packed, executed and unpacked on ``device``.

    While a :class:`~repro_torch.core.calibrate.PhaseTimer` is active the
    call routes through :func:`phased_infer_bits` and records its
    per-phase split on the timer; otherwise the check is one module
    attribute read."""
    dev = resolve_device(device)
    timer = _calibrate._ACTIVE
    if timer is not None:
        out, phases = phased_infer_bits(prog, bits, dev, use_ref=use_ref)
        timer.record(phases, backend="ref" if use_ref or dev.type == "cpu"
                     else "cuda", n_unit=prog.n_unit, batch=out.shape[0])
        return out
    x = _bits_tensor(bits, dev)
    out = logic_forward(prog, pack_bits(x), use_ref=use_ref)
    return unpack_bits(out, x.shape[0]).cpu().numpy()


# ---------------------------------------------------------------------------
# phase-split execution (the calibration measurement path)
# ---------------------------------------------------------------------------

def _phase_host_arrays(prog: LogicProgram, plain: bool) -> dict:
    """Host tensors of what the executor reads, memoized on the program
    object: the streams for the plain version, the launch records and
    output addresses for the kernel (with the records' ``plan``).  The
    phased path uploads them anew on each call, so ``setup`` times a real
    transfer, while the records themselves (lane order, one-barrier
    proof) are built once."""
    memo = _memo(prog)
    key = ("phase_host", plain)
    if key not in memo:
        host = {k: np.ascontiguousarray(getattr(prog, k), dtype=np.int32)
                for k in ("src_a", "src_b", "dst", "opcode", "step_branch",
                          "output_addrs")}
        _check_addresses(prog.n_addr, src_a=host["src_a"],
                         src_b=host["src_b"], dst=host["dst"],
                         output_addrs=host["output_addrs"])
        if plain:
            memo[key] = {k: torch.from_numpy(v) for k, v in host.items()}
        else:
            launch = launch_records(
                host["src_a"], host["src_b"], host["dst"], host["opcode"],
                host["step_branch"], n_addr=prog.n_addr,
                trash=prog.trash_addr, device="cpu")
            memo[key] = {"rec": launch["rec"], "plan": launch["plan"],
                         "output_addrs": torch.from_numpy(
                             host["output_addrs"])}
    return memo[key]


def phased_infer_bits(prog: LogicProgram, bits, device=None,
                      use_ref: bool = False
                      ) -> tuple[np.ndarray, dict[str, float]]:
    """One inference split into the four calibration phases.

    Returns ``(out, phases)`` where ``phases`` maps each of
    ``core.calibrate.PHASES`` to seconds; on CUDA each boundary is fenced
    by ``torch.cuda.synchronize``, so no phase's work runs on into the
    next:

        pack    H2D of the boolean batch + :func:`pack_bits`
        setup   a fresh H2D of what the executor reads: the launch
                records and output addresses for the kernel, the streams
                for the plain version (what the memoized path amortizes)
        kernel  the program execution over packed words (one K1 launch
                on CUDA)
        unpack  :func:`unpack_bits` + D2H of the result

    The output is bit-identical to :func:`logic_infer_bits`'s (the same
    executor on the same words); ``device`` and ``use_ref`` pick it the
    same way.
    """
    dev = resolve_device(device)
    plain = use_ref or dev.type == "cpu"
    host = _phase_host_arrays(prog, plain)

    def fence() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t = time.perf_counter
    t0 = t()
    x = _bits_tensor(bits, dev)
    words = pack_bits(x)
    _check_rows(words, prog.n_inputs)
    fence()
    t1 = t()
    s = {k: v.to(dev, copy=True) for k, v in host.items() if k != "plan"}
    fence()
    t2 = t()
    if plain:
        out_words = logic_forward_ref(
            s["src_a"], s["src_b"], s["dst"], s["opcode"], words,
            s["output_addrs"], prog.n_addr, step_branch=s["step_branch"])
    else:
        out_words = _k.logic_cuda_call(s["rec"], words, s["output_addrs"],
                                       n_addr=prog.n_addr,
                                       plan=host["plan"])
    fence()
    t3 = t()
    out = unpack_bits(out_words, x.shape[0]).cpu().numpy()
    t4 = t()
    phases = {"pack": t1 - t0, "setup": t2 - t1, "kernel": t3 - t2,
              "unpack": t4 - t3}
    return out, phases


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
        arrs["rec"], words, arrs["stage_table"], arrs["out_addrs"],
        arrs["out_rows"], n_addr=mega.n_addr, n_outputs=mega.n_outputs,
        chain=(mega.mode == "chain"), handoff_rows=arrs["handoff_rows"],
        plan=arrs["plan"])


def mega_infer_bits(mega: MegaProgram, bits, device=None,
                    use_ref: bool = False) -> np.ndarray:
    """Boolean convenience wrapper over the mega kernel:
    (batch, n_inputs) -> (batch, n_outputs) in one launch."""
    dev = resolve_device(device)
    x = _bits_tensor(bits, dev)
    out = mega_forward_words(mega, pack_bits(x), use_ref=use_ref)
    return unpack_bits(out, x.shape[0]).cpu().numpy()
