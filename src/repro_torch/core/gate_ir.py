# Copied from src/repro/core/gate_ir.py; only the repro imports differ.
"""Gate-level IR for fixed-function combinational logic (FFCL) modules.

The paper's compiler consumes a combinational netlist (Verilog), maps it to a
2-input gate library supported by the compute units (DSP48 bitwise ALU ops),
levelizes it, and schedules it. ``LogicGraph`` is that netlist: an int-indexed
DAG in topological order.

Wire numbering convention (matches the paper's Tables 2/3):
  wire 0      -> constant 0   (paper: data-vector index 0 = 0x0000)
  wire 1      -> constant 1   (paper: data-vector index 1 = 0xFFFF)
  wires 2..   -> primary inputs, then gates in creation (topological) order
"""
from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

CONST0 = 0
CONST1 = 1


class OpCode(enum.IntEnum):
    """Bitwise ops supported by a compute unit (paper §5: DSP48 logic unit)."""

    NOP = 0    # no operation (paper's NOP padding in sub-kernels)
    AND = 1
    OR = 2
    XOR = 3
    NAND = 4
    NOR = 5
    XNOR = 6
    NOT = 7    # unary: operand b ignored
    COPY = 8   # unary passthrough: used for buffer moves


# numpy-level semantics of each opcode on packed uint32/int32 words.
_OP_FNS = {
    OpCode.NOP: lambda a, b: a * 0,
    OpCode.AND: lambda a, b: a & b,
    OpCode.OR: lambda a, b: a | b,
    OpCode.XOR: lambda a, b: a ^ b,
    OpCode.NAND: lambda a, b: ~(a & b),
    OpCode.NOR: lambda a, b: ~(a | b),
    OpCode.XNOR: lambda a, b: ~(a ^ b),
    OpCode.NOT: lambda a, b: ~a,
    OpCode.COPY: lambda a, b: a,
}

COMMUTATIVE = {OpCode.AND, OpCode.OR, OpCode.XOR, OpCode.NAND, OpCode.NOR,
               OpCode.XNOR}
UNARY = {OpCode.NOT, OpCode.COPY}
# Dispatch-branch index of the generic (mixed-opcode) kernel path: branches
# 0..8 are the specialized per-opcode slab ops, 9 the 8-way chained select.
MIXED_DISPATCH = len(OpCode)
# (op, a==b) -> result expressed as ('wire', operand) or ('const', 0/1) or None
ASSOCIATIVE = {OpCode.AND, OpCode.OR, OpCode.XOR}


def apply_op(op: int, a, b):
    """Apply opcode ``op`` bitwise to packed words ``a``, ``b`` (numpy)."""
    return _OP_FNS[OpCode(op)](a, b)


@dataclass
class LogicGraph:
    """A combinational netlist over a 2-input gate library.

    ``gates[i] = (opcode, src_a, src_b)`` produces wire ``first_gate_wire + i``.
    Wires 0/1 are constants; wires 2..2+n_inputs-1 are primary inputs.
    """

    n_inputs: int
    gates: list[tuple[int, int, int]] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)
    name: str = "ffcl"

    # ---- structure ----
    @property
    def first_gate_wire(self) -> int:
        return 2 + self.n_inputs

    @property
    def n_gates(self) -> int:
        return len(self.gates)

    @property
    def n_wires(self) -> int:
        return 2 + self.n_inputs + self.n_gates

    @property
    def n_outputs(self) -> int:
        return len(self.outputs)

    def input_wire(self, i: int) -> int:
        if not 0 <= i < self.n_inputs:
            raise IndexError(f"input {i} out of range ({self.n_inputs})")
        return 2 + i

    def input_wires(self) -> list[int]:
        return list(range(2, 2 + self.n_inputs))

    def gate_of_wire(self, wire: int) -> tuple[int, int, int]:
        return self.gates[wire - self.first_gate_wire]

    def is_gate(self, wire: int) -> bool:
        return wire >= self.first_gate_wire

    # ---- construction ----
    def add_gate(self, op: OpCode | int, a: int, b: int = CONST0) -> int:
        """Append a gate; operands must already exist (topological order)."""
        op = OpCode(op)
        wire = self.n_wires
        if not (0 <= a < wire) or not (0 <= b < wire):
            raise ValueError(
                f"gate operands ({a},{b}) must precede wire {wire}")
        self.gates.append((int(op), a, b))
        self.__dict__.pop("_fingerprint_cache", None)
        return wire

    def set_outputs(self, outs: Iterable[int]) -> None:
        outs = list(outs)
        for o in outs:
            if not 0 <= o < self.n_wires:
                raise ValueError(f"output wire {o} does not exist")
        self.outputs = outs
        self.__dict__.pop("_fingerprint_cache", None)

    # ---- evaluation (the pure-python/numpy oracle for everything above) ----
    def evaluate(self, inputs: np.ndarray) -> np.ndarray:
        """Evaluate on a batch of boolean inputs.

        Args:
          inputs: bool/int array (batch, n_inputs).
        Returns:
          bool array (batch, n_outputs).
        """
        inputs = np.asarray(inputs)
        if inputs.ndim != 2 or inputs.shape[1] != self.n_inputs:
            raise ValueError(
                f"inputs must be (batch, {self.n_inputs}), got {inputs.shape}")
        batch = inputs.shape[0]
        vals = np.zeros((self.n_wires, batch), dtype=np.uint8)
        vals[CONST1] = 1
        vals[2:2 + self.n_inputs] = inputs.astype(np.uint8).T
        base = self.first_gate_wire
        for i, (op, a, b) in enumerate(self.gates):
            r = apply_op(op, vals[a].astype(np.int64), vals[b].astype(np.int64))
            vals[base + i] = (r & 1).astype(np.uint8)
        return vals[self.outputs].T.astype(bool)

    # ---- analysis ----
    def fingerprint(self) -> str:
        """Stable structural hash: two graphs with identical inputs, gate
        lists, and output wires share a fingerprint regardless of ``name``.

        This is the serving program-cache key (serve/logic_engine.py):
        repeat traffic for a structurally identical FFCL — e.g. the same
        NullaNet layer re-synthesized by another worker — reuses the
        compiled :class:`~repro.core.scheduler.LogicProgram` and its device
        arrays instead of recompiling.

        Memoized against the construction API: ``add_gate`` and
        ``set_outputs`` invalidate the cached digest, and a
        ``(n_inputs, n_gates, outputs)`` guard backstops it, so
        per-request hashing in the serving hot path is O(1) instead of
        O(n_gates). Mutating ``gates`` entries in place (e.g.
        ``g.gates[i] = ...``) bypasses both and would serve a stale
        fingerprint — build graphs through ``add_gate``/``set_outputs``
        only.
        """
        state = (self.n_inputs, self.n_gates, tuple(self.outputs))
        cached = getattr(self, "_fingerprint_cache", None)
        if cached is not None and cached[0] == state:
            return cached[1]
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(self.n_inputs).tobytes())
        if self.gates:
            h.update(np.asarray(self.gates, dtype=np.int64).tobytes())
        h.update(b"|outputs|")
        h.update(np.asarray(self.outputs, dtype=np.int64).tobytes())
        fp = h.hexdigest()
        self._fingerprint_cache = (state, fp)
        return fp

    def fanout_counts(self) -> np.ndarray:
        fo = np.zeros(self.n_wires, dtype=np.int64)
        for op, a, b in self.gates:
            fo[a] += 1
            if OpCode(op) not in UNARY:
                fo[b] += 1
        for o in self.outputs:
            fo[o] += 1
        return fo

    def stats(self) -> dict:
        from repro_torch.core.levelize import levelize  # local import, no cycle
        lv = levelize(self)
        return {
            "name": self.name,
            "n_inputs": self.n_inputs,
            "n_outputs": self.n_outputs,
            "n_gates": self.n_gates,
            "depth": int(lv.depth),
        }

    def copy(self) -> "LogicGraph":
        """Shallow structural copy. The memoized fingerprint carries over
        (structure is identical), so copying a served graph does not
        force an O(n_gates) rehash on the copy's first cache lookup."""
        g = LogicGraph(self.n_inputs, list(self.gates),
                       list(self.outputs), self.name)
        cached = getattr(self, "_fingerprint_cache", None)
        if cached is not None:
            g._fingerprint_cache = cached
        return g


def remap_wires(remap: Sequence[int] | np.ndarray, wires: Iterable[int],
                n_wires: int | None = None, *,
                what: str = "wire") -> list[int]:
    """Map wire ids through an old-wire -> new-wire ``remap``, validated.

    The optimization passes (core/opt.py) and any consumer applying their
    remaps (output lists, partition bookkeeping, layer chaining) go
    through here instead of raw fancy-indexing: a wire outside the
    remap's domain, a wire the rewrite dropped (``remap[w] == -1``), or a
    target at/after ``n_wires`` raises ``ValueError`` — instead of the
    silent corruption a negative index or a stale id would cause
    downstream (numpy happily gathers ``arr[-1]``).

    Args:
      remap: old-wire -> new-wire map; ``-1`` marks dropped wires.
      wires: old wire ids to translate.
      n_wires: when given, every translated id must be ``< n_wires`` —
        pass the new graph's wire count to catch out-of-range targets, or
        a gate's own new wire id to catch forward references (an operand
        that does not precede its gate).
      what: noun used in error messages (``"output"``, ``"operand"``...).
    """
    remap = np.asarray(remap, dtype=np.int64)
    out: list[int] = []
    for w in wires:
        w = int(w)
        if not 0 <= w < len(remap):
            raise ValueError(
                f"{what} {w} outside the remap domain [0, {len(remap)})")
        v = int(remap[w])
        if v < 0:
            raise ValueError(
                f"{what} {w} was dropped by the rewrite (remap is -1) "
                "but is still referenced")
        if n_wires is not None and v >= n_wires:
            raise ValueError(
                f"{what} {w} maps to wire {v}, which is out of range / a "
                f"forward reference (must be < {n_wires})")
        out.append(v)
    return out


def compose_graphs(graphs: Sequence["LogicGraph"],
                   name: str = "stacked") -> LogicGraph:
    """Feed graph k's outputs into graph k+1's primary inputs.

    The stages of a multi-layer NullaNet classifier (flow/) are per-layer
    :class:`LogicGraph` objects whose interface widths chain
    (``graphs[k].n_outputs == graphs[k+1].n_inputs``). Composing them
    yields ONE combinational graph computing the whole hidden stack —
    the artifact the serving engine executes so layer boundaries never
    leave the packed-word domain (and so the partitioner can split the
    stack by output cones rather than by layer).

    Stage k+1's input wire i is rewired to whatever wire produces stage
    k's output i — a constant, a primary input, or a gate — so degenerate
    stages (constant or pass-through outputs) compose exactly.
    """
    graphs = list(graphs)
    if not graphs:
        raise ValueError("compose_graphs needs at least one graph")
    out = LogicGraph(graphs[0].n_inputs, name=name)
    feed = [out.input_wire(i) for i in range(graphs[0].n_inputs)]
    for k, g in enumerate(graphs):
        if g.n_inputs != len(feed):
            raise ValueError(
                f"stage {k} expects {g.n_inputs} inputs, previous stage "
                f"produces {len(feed)}")
        repl = np.zeros(g.n_wires, dtype=np.int64)
        repl[CONST0], repl[CONST1] = CONST0, CONST1
        repl[2:g.first_gate_wire] = feed
        base = g.first_gate_wire
        for i, (op, a, b) in enumerate(g.gates):
            repl[base + i] = out.add_gate(op, int(repl[a]), int(repl[b]))
        feed = [int(repl[o]) for o in g.outputs]
    out.set_outputs(feed)
    return out


# ---------------------------------------------------------------------------
# Random graph generator (tests / benchmarks): well-formed DAGs with
# controllable size/shape, mirroring NullaNet-style FFCL statistics.
# ---------------------------------------------------------------------------

def random_graph(rng: np.random.Generator, n_inputs: int, n_gates: int,
                 n_outputs: int, unary_frac: float = 0.1,
                 locality: int = 64) -> LogicGraph:
    """Random topological DAG; operands biased toward recent wires."""
    g = LogicGraph(n_inputs=n_inputs, name="random")
    binary_ops = [OpCode.AND, OpCode.OR, OpCode.XOR, OpCode.NAND, OpCode.NOR,
                  OpCode.XNOR]
    for _ in range(n_gates):
        hi = g.n_wires
        lo = max(0, hi - locality)
        a = int(rng.integers(lo, hi))
        if rng.random() < unary_frac:
            g.add_gate(OpCode.NOT, a)
        else:
            b = int(rng.integers(lo, hi))
            g.add_gate(rng.choice(binary_ops), a, b)
    n_outputs = min(n_outputs, g.n_wires - 2)
    outs = rng.choice(np.arange(2, g.n_wires), size=n_outputs, replace=False)
    g.set_outputs(int(o) for o in outs)
    return g
