"""Plain PyTorch versions of the logic_dsp kernels (int32 throughout).

Port of ``src/repro/kernels/logic_dsp/ref.py`` plus the stage walk of the
reference's ``ops._mega_forward_ref``.  Semantics contract (identical to
``scheduler.execute_program_np``): a data buffer of ``n_addr`` int32 rows;
row 0 = const0, row 1 = const1 (all ones), rows 2..2+n_inputs hold the
packed primary inputs; per step, unit u computes ``opcode[s,u]`` over rows
``src_a[s,u]``/``src_b[s,u]`` and writes row ``dst[s,u]`` (NOPs write a
trash row).  Outputs are gathered from ``output_addrs`` at the end.

Dispatch is *banked*: a step whose branch is below ``MIXED_DISPATCH`` runs
one slab op on every lane (NOP-padding lanes included; their results land
on the trash row), and only mixed steps pay the per-lane select.  These are
what ``ops`` runs for CPU tensors and what the CUDA kernels are held
against on the card (``pack_bits_ref`` and ``unpack_bits_ref`` against
``csrc/bitpack.cu``'s pack and unpack kernels).  ``logic_forward_records``
and ``mega_forward_records`` repeat the CUDA kernel's own arithmetic (one
index record per lane, each lane's op as a truth table) so the CPU tests
can hold it against the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.gate_ir import MIXED_DISPATCH
from repro_torch.core.packing import WORD_BITS


# ---------------------------------------------------------------------------
# bit packing (LSB-first, the words of core/packing.py)
# ---------------------------------------------------------------------------

def _bit_weights(device) -> torch.Tensor:
    """(32,) int32 ``1 << k``; bit 31 is the int32 sign bit, -2**31."""
    return torch.tensor([1 << k for k in range(WORD_BITS - 1)] + [-2 ** 31],
                        dtype=torch.int32, device=device)


def pack_bits_ref(bits: torch.Tensor) -> torch.Tensor:
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


def unpack_bits_ref(words: torch.Tensor, batch: int) -> torch.Tensor:
    """(n, W) int32 -> (batch, n) bool.  The arithmetic ``>>`` sign-extends
    bit 31, and ``& 1`` keeps only the shifted bit."""
    n, w = words.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(n, w * WORD_BITS)[:, :batch].T.to(torch.bool) \
        .contiguous()


# Branch k (k < MIXED_DISPATCH) is the slab op for opcode k, applied to ALL
# unit rows of the step; branch MIXED_DISPATCH is the per-lane select, whose
# third argument is the step's :func:`opcode_masks` (the slab ops ignore it).
STEP_BRANCHES = (
    lambda a, b, c: torch.zeros_like(a),                    # NOP
    lambda a, b, c: a & b,                                  # AND
    lambda a, b, c: a | b,                                  # OR
    lambda a, b, c: a ^ b,                                  # XOR
    lambda a, b, c: (a & b) ^ -1,                           # NAND
    lambda a, b, c: (a | b) ^ -1,                           # NOR
    lambda a, b, c: (a ^ b) ^ -1,                           # XNOR
    lambda a, b, c: a ^ -1,                                 # NOT
    lambda a, b, c: a,                                      # COPY
    lambda a, b, c: apply_masks(c, a, b),                   # mixed
)
assert len(STEP_BRANCHES) == MIXED_DISPATCH + 1


def _normal_form(slab_op) -> list[int]:
    """``slab_op``'s algebraic normal form, op(a, b) = c0 ^ a c1 ^ b c2 ^
    a b c3, read from the op itself on a = 0b1100, b = 0b1010 (bit 2x + y
    of the result is op(x, y)); each ``c`` 0 or all ones."""
    r = int(slab_op(torch.tensor(0b1100), torch.tensor(0b1010), None))
    f00, f01, f10, f11 = ((r >> i) & 1 for i in range(4))
    return [-f00, -(f10 ^ f00), -(f01 ^ f00), -(f11 ^ f10 ^ f01 ^ f00)]


#: (16, 4) int32: opcode k's normal form (``_normal_form`` of its slab op);
#: opcodes past COPY act as NOP.
NORMAL_FORMS = torch.tensor(
    [_normal_form(op) for op in STEP_BRANCHES[:MIXED_DISPATCH]]
    + [[0] * 4] * (16 - MIXED_DISPATCH), dtype=torch.int32)


def opcode_masks(op: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each opcode's four normal-form masks ``(c0, c1, c2, c3)``, each of
    ``op``'s shape, for :func:`apply_masks`."""
    return NORMAL_FORMS.to(op.device)[op.long().clamp(0, 15)].unbind(-1)


def apply_masks(c: tuple[torch.Tensor, ...], a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The per-lane select in six word ops: ``c`` are
    :func:`opcode_masks` broadcasting against a/b (int32)."""
    c0, c1, c2, c3 = c
    return c0 ^ (a & (c1 ^ (b & c3))) ^ (b & c2)


def apply_opcode(op: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Generic vectorized opcode dispatch; ``op`` broadcasts against a/b
    (int32)."""
    return apply_masks(opcode_masks(op), a, b)


#: Each opcode's truth table, the op the CUDA kernel applies: bit 2x + y is
#: op(x, y) (NOP, AND, OR, XOR, NAND, NOR, XNOR, NOT = not a, COPY = a).
TRUTH_TABLES = (0, 8, 14, 6, 7, 1, 9, 3, 12)
assert len(TRUTH_TABLES) == MIXED_DISPATCH


def apply_truth_table(tt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's op on int32 words: bit k of the result is bit
    ``2 a_k + b_k`` of ``tt`` (which broadcasts against a/b)."""
    m = [-((tt >> k) & 1) for k in range(4)]          # 0 or all ones
    if_a0 = (b & m[1]) | (~b & m[0])
    if_a1 = (b & m[3]) | (~b & m[2])
    return (a & if_a1) | (~a & if_a0)


def decode_records(rec: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(src_a, src_b, dst, truth table) of ``(steps, n_unit, 2)`` packed
    records (``src_a | src_b << 16``, ``dst | tt << 16``) or ``(steps,
    n_unit, 4)`` wide ones, as int64."""
    if rec.shape[-1] == 4:
        return tuple(rec[..., k].long() for k in range(4))
    lo = rec.long() & 0xFFFF
    hi = (rec.long() >> 16) & 0xFFFF
    return lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]


def logic_forward_records(rec: torch.Tensor, input_words: torch.Tensor,
                          output_addrs: torch.Tensor,
                          n_addr: int) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch: the program run from
    its index records (``ops.launch_records``) with the truth-table op,
    every read of a step before its writes.  Computes what
    :func:`logic_forward_ref` computes from the four streams."""
    n_inputs, w = input_words.shape
    buf = torch.zeros((n_addr, w), dtype=torch.int32,
                      device=input_words.device)
    buf[1] = -1
    buf[2:2 + n_inputs] = input_words
    src_a, src_b, dst, tt = decode_records(rec)
    for s in range(rec.shape[0]):
        tts = tt[s].to(torch.int32)[:, None]
        buf[dst[s]] = apply_truth_table(tts, buf[src_a[s]], buf[src_b[s]])
    return buf[output_addrs.long()]


def mega_forward_records(rec: torch.Tensor, words: torch.Tensor,
                         stage_table: torch.Tensor, out_addrs: torch.Tensor,
                         out_rows: torch.Tensor, n_addr: int,
                         chain: bool) -> torch.Tensor:
    """The CUDA kernel's stage walk (K2) in plain PyTorch, from the
    records of the concatenated streams and the ``ops.mega_arrays`` stage
    table: chain mode feeds each stage's outputs to the next, parallel
    mode writes stage output j to row ``out_rows[out_lo + j]``."""
    h, slabs = words, []
    for lo, hi, n_in, n_out, o in stage_table.tolist():
        r = logic_forward_records(rec[lo:hi], (h if chain else words)[:n_in],
                                  out_addrs[o:o + n_out], n_addr)
        if chain:
            h = r
        else:
            slabs.append(r)
    if chain:
        return h
    cat = torch.cat(slabs)
    out = torch.empty_like(cat)
    out[out_rows.long()] = cat
    return out


def logic_forward_ref(src_a: torch.Tensor, src_b: torch.Tensor,
                      dst: torch.Tensor, opcode: torch.Tensor,
                      input_words: torch.Tensor, output_addrs: torch.Tensor,
                      n_addr: int,
                      step_branch: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Execute the program on packed inputs.

    Args:
      src_a/src_b/dst/opcode: (n_steps, n_unit) int32 program streams.
      input_words: (n_inputs, W) int32 packed inputs (row i = input i).
      output_addrs: (n_outputs,) int32.
      n_addr: buffer rows (incl. consts + trash).
      step_branch: (n_steps,) int32 per-step dispatch branch
        (``LogicProgram.step_branch``); None forces the generic dispatch on
        every step.
    Returns:
      (n_outputs, W) int32 packed outputs.
    """
    n_inputs, w = input_words.shape
    buf = torch.zeros((n_addr, w), dtype=torch.int32,
                      device=input_words.device)
    buf[1] = -1
    buf[2:2 + n_inputs] = input_words
    n_steps = src_a.shape[0]
    branches = ([MIXED_DISPATCH] * n_steps if step_branch is None
                else step_branch.tolist())
    masks = ([None] * n_steps if max(branches, default=0) < MIXED_DISPATCH
             else zip(*(m.unbind(0) for m in opcode_masks(opcode[..., None]))))
    for ia, ib, io, branch, c in zip(src_a.long().unbind(0),
                                     src_b.long().unbind(0),
                                     dst.long().unbind(0), branches, masks):
        buf[io] = STEP_BRANCHES[branch](buf[ia], buf[ib], c)
    return buf[output_addrs.long()]


def mega_forward_ref(mega, arrs: dict, words: torch.Tensor) -> torch.Tensor:
    """Plain mega execution: the per-stage :func:`logic_forward_ref` chain
    (``mega.mode == "chain"``) or fan-out re-assembled through the output
    permutation (``"parallel"``) that the mega kernel fuses.  ``arrs`` are
    the ``ops.mega_arrays`` tensors on ``words``' device."""
    def stage(meta, stage_words):
        step_lo, step_hi, n_in, n_out, out_lo = meta
        return logic_forward_ref(
            arrs["src_a"][step_lo:step_hi], arrs["src_b"][step_lo:step_hi],
            arrs["dst"][step_lo:step_hi], arrs["opcode"][step_lo:step_hi],
            stage_words, arrs["out_addrs"][out_lo:out_lo + n_out],
            mega.n_addr, step_branch=arrs["step_branch"][step_lo:step_hi])

    if mega.mode == "chain":
        h = words
        for meta in mega.stage_meta:
            h = stage(meta, h)
        return h
    slabs = [stage(meta, words) for meta in mega.stage_meta]
    cat = slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=0)
    return cat[arrs["perm"].long()]
