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
against on the card.
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
