# Copied from src/repro/core/opt.py; only the repro imports differ.
"""Pass-based logic-optimization pipeline over :class:`LogicGraph`.

The NullaNet/espresso synthesis path emits graphs with duplicate AND/OR
cones, constant-fed gates, and dead fanin; eq. 23 charges every one of
them as scheduled sub-kernel work. This module is the gate-level
optimization layer (DESIGN.md §7) that shrinks ``n_gates`` — and with it
``n_steps``, the VMEM-resident address streams, and partition cone sizes —
before anything is levelized or scheduled.

Architecture: small single-purpose *passes*, each a semantics-preserving
graph rewrite that returns the rewritten graph **plus a wire remap**
(:class:`PassResult`), composed by a :class:`PassManager` that iterates
them to a fixed point on ``(n_gates, depth)``.

The wire-remap contract (every pass, and the composed pipeline):

  * ``remap`` has one entry per wire of the *input* graph;
  * constants and primary inputs always map to themselves (passes never
    add, drop, or reorder primary inputs);
  * ``remap[w] == v >= 0`` means new wire ``v`` computes exactly the
    Boolean function old wire ``w`` computed (on every input assignment);
  * ``remap[w] == -1`` means the wire was dropped (dead code) — nothing
    may reference it afterwards (``gate_ir.remap_wires`` raises instead
    of silently gathering a corrupt id);
  * output lists are remapped in order, so multi-output ordering and
    ``compose_graphs`` chaining survive any pipeline.

Passes (ABC's ``resyn``-family stand-ins, on the 9-opcode DSP library):

  * :class:`ConstantFold`      — absorb CONST0/CONST1 operands through
    every opcode (incl. NOP -> CONST0: a NOP gate's wire is always 0);
  * :class:`SimplifyIdentities`— COPY elimination, double-NOT, NOT-fusion
    into the negated opcodes (NAND/NOR/XNOR...), idempotence /
    annihilation of ``op(x, x)``;
  * :class:`StructuralHash`    — common-subexpression elimination: dedupe
    ``(op, a, b)`` up to commutativity;
  * :class:`DeadGateElim`      — drop gates outside every output cone;
  * :class:`Rebalance`         — rebuild single-fanout associative chains
    as balanced trees (depth, not gate count).

``PassManager.default()`` is the pipeline every synthesis consumer routes
through via the shared ``optimize=`` knob: on by default in
``nullanet.layer_to_graph``, ``flow/convert.py``, and the serving engine;
opt-in (default ``"none"``) on the raw primitives
``espresso.sop_to_graph`` and ``scheduler.compile_graph`` (which runs it
before levelization), whose defaults preserve the paper-exact factoring
and eq. 23 contracts. ``serve.ProgramCache`` keys compiled programs on
the *post-optimization* fingerprint so structurally-equal requests share
one cache entry.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.gate_ir import (ASSOCIATIVE, COMMUTATIVE, CONST0, CONST1,
                                LogicGraph, OpCode, UNARY, remap_wires)

# (op, const_operand_value) -> what the gate reduces to when one operand
# is that constant: ('const', v) | ('pass',) keep the other operand |
# ('not',) negate the other operand.
_CONST_RULES = {
    (OpCode.AND, 0): ("const", 0), (OpCode.AND, 1): ("pass",),
    (OpCode.OR, 0): ("pass",), (OpCode.OR, 1): ("const", 1),
    (OpCode.XOR, 0): ("pass",), (OpCode.XOR, 1): ("not",),
    (OpCode.NAND, 0): ("const", 1), (OpCode.NAND, 1): ("not",),
    (OpCode.NOR, 0): ("not",), (OpCode.NOR, 1): ("const", 0),
    (OpCode.XNOR, 0): ("not",), (OpCode.XNOR, 1): ("pass",),
}

# op applied to (x, x) -> result (idempotence / annihilation / involution)
_IDEMPOTENT_RULES = {
    OpCode.AND: ("pass",), OpCode.OR: ("pass",),
    OpCode.XOR: ("const", 0), OpCode.XNOR: ("const", 1),
    OpCode.NAND: ("not",), OpCode.NOR: ("not",),
}

_NEGATED = {OpCode.AND: OpCode.NAND, OpCode.NAND: OpCode.AND,
            OpCode.OR: OpCode.NOR, OpCode.NOR: OpCode.OR,
            OpCode.XOR: OpCode.XNOR, OpCode.XNOR: OpCode.XOR,
            OpCode.NOT: OpCode.COPY, OpCode.COPY: OpCode.NOT}


@dataclass(frozen=True)
class PassResult:
    """A rewritten graph plus the old-wire -> new-wire map (see module
    docstring for the remap contract)."""

    graph: LogicGraph
    remap: np.ndarray          # (old.n_wires,) int64; -1 = dropped


def identity_remap(graph: LogicGraph) -> np.ndarray:
    """The do-nothing remap (constants + inputs + every gate in place)."""
    return np.arange(graph.n_wires, dtype=np.int64)


def compose_remaps(first: np.ndarray, then: np.ndarray) -> np.ndarray:
    """Remap of running ``first`` and ``then`` back-to-back: dropped (-1)
    wires stay dropped; live wires gather through both maps."""
    out = np.full(len(first), -1, dtype=np.int64)
    live = first >= 0
    out[live] = then[first[live]]
    return out


def _prefix_remap(graph: LogicGraph) -> np.ndarray:
    """Fresh remap with constants + primary inputs mapped to themselves
    and every gate still unmapped (-1)."""
    repl = np.full(graph.n_wires, -1, dtype=np.int64)
    repl[:graph.first_gate_wire] = np.arange(graph.first_gate_wire)
    return repl


class Pass:
    """One semantics-preserving rewrite. Subclasses implement :meth:`run`
    and must honour the wire-remap contract of the module docstring."""

    name = "pass"

    def run(self, graph: LogicGraph) -> PassResult:
        raise NotImplementedError

    def __call__(self, graph: LogicGraph) -> PassResult:
        return self.run(graph)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class ConstantFold(Pass):
    """Constant folding / propagation through all 9 opcodes.

    A gate whose operand resolved to CONST0/CONST1 is absorbed by the
    rules table; NOP gates fold to CONST0 outright (their wire is always
    0); folds cascade forward because operands are resolved through the
    running remap. Rules that negate the surviving operand emit a NOT
    gate (deduped per operand so a constant-heavy layer cannot fan out
    into a pile of identical inverters).
    """

    name = "const-fold"

    def run(self, graph: LogicGraph) -> PassResult:
        new = LogicGraph(graph.n_inputs, name=graph.name)
        repl = _prefix_remap(graph)
        nots: dict[int, int] = {}        # operand -> its NOT wire in `new`

        def emit_not(x: int) -> int:
            if x == CONST0:
                return CONST1
            if x == CONST1:
                return CONST0
            if x not in nots:
                nots[x] = new.add_gate(OpCode.NOT, x)
            return nots[x]

        base = graph.first_gate_wire
        for i, (op, a, b) in enumerate(graph.gates):
            op = OpCode(op)
            a, b = int(repl[a]), int(repl[b])
            if op == OpCode.NOP:            # NOP's wire is identically 0
                repl[base + i] = CONST0
                continue
            if op == OpCode.COPY:
                repl[base + i] = a
                continue
            if op == OpCode.NOT:
                repl[base + i] = emit_not(a)
                continue
            folded = None
            for x, y in ((a, b), (b, a)):
                if y in (CONST0, CONST1):
                    rule = _CONST_RULES[(op, y)]
                    if rule[0] == "const":
                        folded = CONST1 if rule[1] else CONST0
                    elif rule[0] == "pass":
                        folded = x
                    else:                    # 'not'
                        folded = emit_not(x)
                    break
            repl[base + i] = folded if folded is not None \
                else new.add_gate(op, a, b)
        new.set_outputs(remap_wires(repl, graph.outputs, new.n_wires,
                                    what="output"))
        return PassResult(new, repl)


class SimplifyIdentities(Pass):
    """Double-negation / identity simplification.

    ``COPY(x) -> x``; ``NOT(NOT(x)) -> x``; ``NOT(g(x, y))`` fuses into
    the negated opcode (``NOT(AND) -> NAND`` etc. — "technology mapping"
    onto the full DSP opcode set); ``op(x, x)`` collapses by idempotence
    (AND/OR), annihilation (XOR -> 0, XNOR -> 1), or negation
    (NAND/NOR -> NOT x). Fusion may leave the original inner gate with
    no remaining readers — :class:`DeadGateElim` collects it.
    """

    name = "simplify-identities"

    def run(self, graph: LogicGraph) -> PassResult:
        new = LogicGraph(graph.n_inputs, name=graph.name)
        repl = _prefix_remap(graph)
        new_def: dict[int, tuple[int, int, int]] = {}

        def emit(op: OpCode, a: int, b: int) -> int:
            w = new.add_gate(op, a, b if op not in UNARY else CONST0)
            new_def[w] = (int(op), a, b)
            return w

        def resolve(op: OpCode, a: int, b: int) -> int:
            if op == OpCode.COPY:
                return a
            if op == OpCode.NOT:
                if a == CONST0:
                    return CONST1
                if a == CONST1:
                    return CONST0
                if a in new_def:
                    dop, da, db = new_def[a]
                    dop = OpCode(dop)
                    if dop == OpCode.NOT:          # double negation
                        return da
                    if dop in _NEGATED:            # NOT fusion
                        return resolve(_NEGATED[dop], da, db)
                return emit(op, a, CONST0)
            if a == b:
                rule = _IDEMPOTENT_RULES.get(op)
                if rule is not None:
                    if rule[0] == "const":
                        return CONST1 if rule[1] else CONST0
                    if rule[0] == "pass":
                        return a
                    return resolve(OpCode.NOT, a, CONST0)
            return emit(op, a, b)

        base = graph.first_gate_wire
        for i, (op, a, b) in enumerate(graph.gates):
            repl[base + i] = resolve(OpCode(op), int(repl[a]), int(repl[b]))
        new.set_outputs(remap_wires(repl, graph.outputs, new.n_wires,
                                    what="output"))
        return PassResult(new, repl)


class StructuralHash(Pass):
    """Structural hashing / common-subexpression elimination.

    Canonicalizes each gate — commutative operands sorted, unary ``b``
    pinned to CONST0, NOP operands pinned to (CONST0, CONST0) since its
    result ignores them — and dedupes identical ``(op, a, b)`` keys onto
    one wire. Duplicate AND/OR cones (the espresso factoring's main
    residue across outputs) collapse bottom-up because operands are
    resolved through the running remap before hashing.
    """

    name = "structural-hash"

    def run(self, graph: LogicGraph) -> PassResult:
        new = LogicGraph(graph.n_inputs, name=graph.name)
        repl = _prefix_remap(graph)
        table: dict[tuple[int, int, int], int] = {}
        base = graph.first_gate_wire
        for i, (op, a, b) in enumerate(graph.gates):
            op = OpCode(op)
            a, b = int(repl[a]), int(repl[b])
            if op == OpCode.NOP:
                a = b = CONST0
            elif op in UNARY:
                b = CONST0
            elif op in COMMUTATIVE and a > b:
                a, b = b, a
            key = (int(op), a, b)
            if key not in table:
                table[key] = new.add_gate(op, a, b)
            repl[base + i] = table[key]
        new.set_outputs(remap_wires(repl, graph.outputs, new.n_wires,
                                    what="output"))
        return PassResult(new, repl)


class DeadGateElim(Pass):
    """Drop every gate not reachable backwards from an output cone."""

    name = "dead-gate-elim"

    def run(self, graph: LogicGraph) -> PassResult:
        live = np.zeros(graph.n_wires, dtype=bool)
        live[:graph.first_gate_wire] = True
        stack = [o for o in graph.outputs if graph.is_gate(o)]
        seen: set[int] = set()
        while stack:
            w = stack.pop()
            if w in seen:
                continue
            seen.add(w)
            live[w] = True
            op, a, b = graph.gate_of_wire(w)
            op = OpCode(op)
            if op == OpCode.NOP:        # result ignores BOTH operands
                continue
            if graph.is_gate(a):
                stack.append(a)
            if op not in UNARY and graph.is_gate(b):
                stack.append(b)
        new = LogicGraph(graph.n_inputs, name=graph.name)
        repl = _prefix_remap(graph)
        base = graph.first_gate_wire
        for i, (op, a, b) in enumerate(graph.gates):
            w = base + i
            if live[w]:
                op = OpCode(op)
                # ignored operands may reference dead gates (repl == -1):
                # pin them to CONST0 like the other passes (NOP ignores
                # both operands, NOT/COPY ignore b)
                na = CONST0 if op == OpCode.NOP else int(repl[a])
                nb = CONST0 if op == OpCode.NOP or op in UNARY \
                    else int(repl[b])
                repl[w] = new.add_gate(op, na, nb)
        new.set_outputs(remap_wires(repl, graph.outputs, new.n_wires,
                                    what="output"))
        return PassResult(new, repl)


class Rebalance(Pass):
    """Rebuild single-fanout associative same-op chains as min-depth trees.

    ``(((a&b)&c)&d)`` (depth 3) becomes the depth-2 balanced tree. The
    rebuild is *depth-aware*: leaves carry their logic level in the new
    graph, and the tree is built Huffman-style — always combining the two
    shallowest nodes — which is depth-optimal for the leaf multiset and
    therefore never deeper than the original tree (a naive pairwise
    rebuild can pair a deep leaf late and *increase* depth, which made
    the old fixed-point loop oscillate instead of converging). Only
    internal nodes with fanout 1 are absorbed, so gate count never grows;
    depth — eq. 23's level count — monotonically shrinks. Absorbed
    internal wires are dropped from the remap (-1): no later consumer
    exists by definition.
    """

    name = "rebalance"

    def run(self, graph: LogicGraph) -> PassResult:
        fanout = graph.fanout_counts()
        new = LogicGraph(graph.n_inputs, name=graph.name)
        repl = _prefix_remap(graph)
        base = graph.first_gate_wire
        lvl = [0] * graph.n_wires            # new-wire logic levels
        absorbed = np.zeros(graph.n_wires, dtype=bool)
        for op, a, b in graph.gates:
            op = OpCode(op)
            if op not in ASSOCIATIVE:
                continue
            for child in (a, b):
                if graph.is_gate(child) and fanout[child] == 1:
                    cop, _, _ = graph.gate_of_wire(child)
                    if OpCode(cop) == op:
                        absorbed[child] = True

        def emit(op: OpCode, a: int, b: int) -> int:
            if op in UNARY:
                b = CONST0        # the ignored operand may have been absorbed
            w = new.add_gate(op, a, b)
            if w >= len(lvl):
                lvl.extend([0] * (w + 1 - len(lvl)))
            lvl[w] = max(lvl[a], lvl[b]) + 1
            return w

        def collect(wire: int, op: OpCode, leaves: list[int]) -> None:
            # explicit stack (serial chains can be thousands of gates
            # deep — recursion would overflow on the serving path)
            stack = [wire]
            while stack:
                w = stack.pop()
                if graph.is_gate(w) and absorbed[w]:
                    gop, a, b = graph.gate_of_wire(w)
                    if OpCode(gop) == op:
                        stack.append(b)      # a pops first: left-to-right
                        stack.append(a)
                        continue
                leaves.append(w)

        def build(op: OpCode, leaves: list[int]) -> int:
            # (level, tiebreak, wire) min-heap; combining the two
            # shallowest nodes first is depth-optimal for the leaf set
            heap = [(lvl[int(repl[w])], k, int(repl[w]))
                    for k, w in enumerate(leaves)]
            heapq.heapify(heap)
            tie = len(heap)
            while len(heap) > 1:
                la, _, a = heapq.heappop(heap)
                lb, _, b = heapq.heappop(heap)
                w = emit(op, a, b)
                heapq.heappush(heap, (lvl[w], tie, w))
                tie += 1
            return heap[0][2]

        for i, (op, a, b) in enumerate(graph.gates):
            w = base + i
            if absorbed[w]:
                continue
            op = OpCode(op)
            if op in ASSOCIATIVE:
                leaves: list[int] = []
                collect(a, op, leaves)
                collect(b, op, leaves)
                repl[w] = build(op, leaves)
            else:
                repl[w] = emit(op, int(repl[a]), int(repl[b]))
        new.set_outputs(remap_wires(repl, graph.outputs, new.n_wires,
                                    what="output"))
        return PassResult(new, repl)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@dataclass
class OptResult:
    """Composed result of a :class:`PassManager` run.

    ``remap`` composes every pass of every iteration, so it maps wires of
    the graph handed to :meth:`PassManager.run` directly onto the final
    graph under the same contract as a single :class:`PassResult`.
    """

    graph: LogicGraph
    remap: np.ndarray
    iterations: int
    pass_stats: list[dict] = field(default_factory=list)

    def summary(self) -> str:
        lines = [f"{s['pass']}: {s['gates_in']} -> {s['gates_out']} gates"
                 for s in self.pass_stats if s["gates_in"] != s["gates_out"]]
        return "; ".join(lines) or "fixed point (no change)"


class PassManager:
    """Iterate a pass list to a fixed point on ``(n_gates, depth)``.

    ``run`` composes each pass's wire remap, so callers that need to
    track where an old wire went (e.g. layer chaining, partition
    bookkeeping) read one map regardless of how many iterations fired.
    The manager is stateless across runs and safe to share.
    """

    def __init__(self, passes: Sequence[Pass], max_iters: int = 8,
                 name: str = "pipeline"):
        if max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        self.passes = list(passes)
        self.max_iters = max_iters
        self.name = name

    @classmethod
    def default(cls, max_iters: int = 8) -> "PassManager":
        """The standard synthesis pipeline (ABC ``resyn2`` stand-in):
        fold constants, simplify identities, hash-cons, sweep dead gates,
        rebalance for depth, sweep again."""
        return cls([ConstantFold(), SimplifyIdentities(), StructuralHash(),
                    DeadGateElim(), Rebalance(), DeadGateElim()],
                   max_iters=max_iters, name="default")

    @property
    def cache_key(self) -> tuple:
        """Deterministic identity of the pipeline *configuration* — what
        the serving :class:`~repro.serve.ProgramCache` folds into its
        optimized-graph memo so engines with different pipelines sharing
        one cache never serve each other's rewrites. Passes are
        identified by their class (module + qualname), not just the
        ``name`` attribute, so two custom subclasses that forgot to
        override ``name`` cannot collide in the memo."""
        return (self.name,
                tuple((type(p).__module__, type(p).__qualname__, p.name)
                      for p in self.passes),
                self.max_iters)

    def run(self, graph: LogicGraph, *, certify: bool = False) -> OptResult:
        """Run the pipeline to a fixed point.

        ``certify=True`` (the ``verify="compile"/"full"`` path,
        core/verify.py) checks every individual pass's wire remap
        against the certificate — total and in-range on outputs,
        constants/inputs fixed — and raises
        ``ScheduleVerificationError`` naming the offending pass, so a
        broken rewrite is localized to the pass that emitted it instead
        of surfacing as a composed-map failure at the end."""
        from repro_torch.core.levelize import levelize   # local import, no cycle
        cur = graph
        remap = identity_remap(graph)
        stats: list[dict] = []
        prev_key = None
        iters = 0
        for _ in range(self.max_iters):
            iters += 1
            fp_in = cur.fingerprint()
            for p in self.passes:
                before = cur.n_gates
                res = p.run(cur)
                if certify:
                    # lazy import: verify is a leaf module, but keep the
                    # zero-cost default path import-free
                    from repro_torch.core.verify import (
                        ScheduleVerificationError, VerifyReport,
                        certify_remap)
                    diags = certify_remap(
                        cur, res.graph, res.remap,
                        label=f"{self.name}:{p.name}[iter {iters}]")
                    if diags:
                        raise ScheduleVerificationError(VerifyReport(
                            target=graph.name,
                            diagnostics=tuple(diags)))
                remap = compose_remaps(remap, res.remap)
                stats.append({"pass": p.name, "gates_in": before,
                              "gates_out": res.graph.n_gates})
                cur = res.graph
            # true fixed point (identical structure): an already-optimized
            # graph — e.g. a composed stack of optimized layers hitting
            # the serving pipeline — stops after ONE iteration instead of
            # paying a full confirmation rebuild; the (n_gates, depth)
            # guard below backstops count-stable structural churn.
            if cur.fingerprint() == fp_in:
                break
            key = (cur.n_gates, levelize(cur).depth)
            if key == prev_key:
                break
            prev_key = key
        return OptResult(graph=cur, remap=remap, iterations=iters,
                         pass_stats=stats)

    def optimize(self, graph: LogicGraph) -> LogicGraph:
        """Graph-only convenience over :meth:`run`."""
        return self.run(graph).graph

    # Two managers with the same configuration identity run the same
    # rewrites, so they compare (and hash) equal — what makes
    # ``CompileSpec(optimize="default")`` equal however the default
    # pipeline was spelled (core/spec.py normalizes on construction).
    def __eq__(self, other) -> bool:
        return (isinstance(other, PassManager)
                and self.cache_key == other.cache_key)

    def __hash__(self) -> int:
        return hash(self.cache_key)

    def __repr__(self) -> str:
        return (f"PassManager({self.name!r}, "
                f"passes={[p.name for p in self.passes]}, "
                f"max_iters={self.max_iters})")


def resolve_pipeline(optimize) -> PassManager | None:
    """Normalize the ``optimize=`` knob every consumer shares.

    ``"default"`` / ``True`` -> :meth:`PassManager.default`;
    ``"none"`` / ``None`` / ``False`` -> no optimization;
    a :class:`PassManager` instance passes through unchanged;
    a :class:`~repro.core.spec.CompileSpec` contributes its resolved
    ``pipeline`` (so graph-stage knobs like ``FfclStats.from_graph
    (optimized=spec)`` accept the one declarative target directly).
    """
    if optimize is None or optimize is False or optimize == "none":
        return None
    if optimize is True or optimize == "default":
        return PassManager.default()
    if isinstance(optimize, PassManager):
        return optimize
    from repro_torch.core.spec import CompileSpec   # lazy: spec imports this module
    if isinstance(optimize, CompileSpec):
        return optimize.pipeline
    raise ValueError(
        f"optimize must be 'default', 'none', a PassManager, or a "
        f"CompileSpec; got {optimize!r}")
