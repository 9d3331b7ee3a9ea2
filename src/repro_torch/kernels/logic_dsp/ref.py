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
against on the card.  ``logic_forward_records`` and
``mega_forward_records`` repeat the CUDA kernel's own arithmetic (one index
record per lane, each lane's op as a truth table) so the CPU tests can hold
it against the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.gate_ir import MIXED_DISPATCH


def apply_opcode(op: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Generic vectorized opcode dispatch; ``op`` broadcasts against a/b
    (int32). Used for mixed-opcode steps only."""
    r = torch.zeros_like(a)                                 # NOP = 0
    r = torch.where(op == 1, a & b, r)                      # AND
    r = torch.where(op == 2, a | b, r)                      # OR
    r = torch.where(op == 3, a ^ b, r)                      # XOR
    r = torch.where(op == 4, (a & b) ^ -1, r)               # NAND
    r = torch.where(op == 5, (a | b) ^ -1, r)               # NOR
    r = torch.where(op == 6, (a ^ b) ^ -1, r)               # XNOR
    r = torch.where(op == 7, a ^ -1, r)                     # NOT
    r = torch.where(op == 8, a, r)                          # COPY
    return r


# Branch k (k < MIXED_DISPATCH) is the slab op for opcode k, applied to ALL
# unit rows of the step; branch MIXED_DISPATCH is the per-lane select.
STEP_BRANCHES = (
    lambda a, b, ops: torch.zeros_like(a),                  # NOP
    lambda a, b, ops: a & b,                                # AND
    lambda a, b, ops: a | b,                                # OR
    lambda a, b, ops: a ^ b,                                # XOR
    lambda a, b, ops: (a & b) ^ -1,                         # NAND
    lambda a, b, ops: (a | b) ^ -1,                         # NOR
    lambda a, b, ops: (a ^ b) ^ -1,                         # XNOR
    lambda a, b, ops: a ^ -1,                               # NOT
    lambda a, b, ops: a,                                    # COPY
    lambda a, b, ops: apply_opcode(ops[:, None], a, b),     # mixed
)
assert len(STEP_BRANCHES) == MIXED_DISPATCH + 1


def apply_step(branch: int, opcodes: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One step on (n_unit, W) operand slabs: a single bitwise slab op for
    homogeneous steps, the per-lane select otherwise."""
    return STEP_BRANCHES[int(branch)](a, b, opcodes)


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
    src_a, src_b, dst = src_a.long(), src_b.long(), dst.long()
    branches = (None if step_branch is None else step_branch.tolist())
    for s in range(src_a.shape[0]):
        a = buf[src_a[s]]                                   # (n_unit, W)
        b = buf[src_b[s]]
        if branches is None:
            r = apply_opcode(opcode[s][:, None], a, b)
        else:
            r = apply_step(branches[s], opcode[s], a, b)
        buf[dst[s]] = r
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
