# Copied from src/repro/core/verilog.py; only the repro imports differ.
"""Structural-Verilog front-end/back-end for FFCL modules (paper §4).

Place in the synthesis flow: this is the *interchange boundary* of the
compiler. The paper's flow starts from "a description of a FFCL module in
Verilog format" — NullaNet (core/nullanet.py) emits one netlist per neuron
after two-level minimization (core/espresso.py) and multi-level
restructuring (core/synth.py); ABC/Yosys-normalized third-party netlists
enter the same way. ``parse_verilog`` turns that text into the
:class:`~repro.core.gate_ir.LogicGraph` every downstream stage (levelize ->
schedule -> kernel/serving) consumes, and ``emit_verilog`` closes the loop
for hand-off back to HLS/FPGA tooling (round-trip tested in
tests/test_gate_ir.py).

We support the gate-level subset those tools emit:

  module m(a, b, y);
    input a, b;  output y;  wire w1;
    and g0 (w1, a, b);          // gate primitives: and/or/xor/nand/nor/xnor/
    assign y = ~(w1 ^ b);       // not/buf; or assign with ~ & | ^ and parens
  endmodule

Continuous assigns are parsed with a tiny recursive-descent expression parser
and decomposed into 2-input gates on the fly; statements may appear in any
order (netlists need not be topologically sorted).

>>> import numpy as np
>>> g = parse_verilog('''
...   module m(a, b, y);
...     input a, b;  output y;  wire w1;
...     and g0 (w1, a, b);
...     assign y = ~(w1 ^ b);
...   endmodule''')
>>> g.n_inputs, g.n_outputs, g.n_gates   # and, xor, not
(2, 1, 3)
>>> bool(g.evaluate(np.array([[1, 1]], dtype=bool))[0, 0])  # ~((a&b)^b) = 1
True
>>> parse_verilog(emit_verilog(g)).n_gates                  # round-trips
3
"""
from __future__ import annotations

import re

from repro_torch.core.gate_ir import CONST0, CONST1, LogicGraph, OpCode

_PRIMS = {"and": OpCode.AND, "or": OpCode.OR, "xor": OpCode.XOR,
          "nand": OpCode.NAND, "nor": OpCode.NOR, "xnor": OpCode.XNOR,
          "not": OpCode.NOT, "buf": OpCode.COPY}

_TOKEN = re.compile(r"\s*(\(|\)|~|\^|&|\||1'b[01]|[A-Za-z_][A-Za-z0-9_$\[\]]*)")


class _ExprParser:
    """Precedence: ~  >  &  >  ^  >  |   (Verilog)."""

    def __init__(self, text: str, lookup, emit):
        self.toks = _TOKEN.findall(text)
        self.pos = 0
        self.lookup = lookup   # name -> wire id
        self.emit = emit       # (op, a, b) -> wire id

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def take(self):
        t = self.peek()
        self.pos += 1
        return t

    def parse(self) -> int:
        w = self._or()
        if self.peek() is not None:
            raise ValueError(f"trailing tokens: {self.toks[self.pos:]}")
        return w

    def _or(self) -> int:
        w = self._xor()
        while self.peek() == "|":
            self.take()
            w = self.emit(OpCode.OR, w, self._xor())
        return w

    def _xor(self) -> int:
        w = self._and()
        while self.peek() == "^":
            self.take()
            w = self.emit(OpCode.XOR, w, self._and())
        return w

    def _and(self) -> int:
        w = self._unary()
        while self.peek() == "&":
            self.take()
            w = self.emit(OpCode.AND, w, self._unary())
        return w

    def _unary(self) -> int:
        t = self.take()
        if t == "~":
            return self.emit(OpCode.NOT, self._unary(), CONST0)
        if t == "(":
            w = self._or()
            if self.take() != ")":
                raise ValueError("expected ')'")
            return w
        if t == "1'b0":
            return CONST0
        if t == "1'b1":
            return CONST1
        return self.lookup(t)


def parse_verilog(text: str) -> LogicGraph:
    """Parse a single gate-level module into a LogicGraph."""
    text = re.sub(r"//.*?$", "", text, flags=re.M)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    m = re.search(r"module\s+([A-Za-z_][\w$]*)\s*\((.*?)\)\s*;(.*?)endmodule",
                  text, flags=re.S)
    if not m:
        raise ValueError("no module found")
    name, _, body = m.groups()

    def split_decl(kind: str) -> list[str]:
        names: list[str] = []
        for dm in re.finditer(rf"\b{kind}\b\s*(.*?);", body, flags=re.S):
            names.extend(n.strip() for n in dm.group(1).split(",") if n.strip())
        return names

    inputs, outputs = split_decl("input"), split_decl("output")
    graph = LogicGraph(len(inputs), name=name)
    wires: dict[str, int] = {nm: graph.input_wire(i)
                             for i, nm in enumerate(inputs)}

    pending: list[tuple] = []  # statements awaiting operand definitions
    for stmt in re.split(r";", body):
        stmt = stmt.strip()
        if not stmt or re.match(r"\b(input|output|wire)\b", stmt):
            continue
        gm = re.match(r"(\w+)\s+[A-Za-z_][\w$]*\s*\(\s*([^)]*)\)", stmt)
        am = re.match(r"assign\s+([A-Za-z_][\w$\[\]]*)\s*=\s*(.*)", stmt,
                      flags=re.S)
        if gm and gm.group(1) in _PRIMS:
            args = [a.strip() for a in gm.group(2).split(",")]
            pending.append(("gate", _PRIMS[gm.group(1)], args[0], args[1:]))
        elif am:
            pending.append(("assign", am.group(1), am.group(2)))
        elif stmt:
            raise ValueError(f"unsupported statement: {stmt!r}")

    def lookup(nm: str) -> int:
        if nm == "1'b0":
            return CONST0
        if nm == "1'b1":
            return CONST1
        if nm not in wires:
            raise KeyError(nm)
        return wires[nm]

    def emit(op: OpCode, a: int, b: int) -> int:
        return graph.add_gate(op, a, b)

    # iterate until all statements resolve (netlists need not be in topo order)
    remaining = pending
    while remaining:
        progressed, nxt = False, []
        for item in remaining:
            try:
                if item[0] == "gate":
                    _, op, out, ins = item
                    srcs = [lookup(x) for x in ins]
                    a = srcs[0]
                    b = srcs[1] if len(srcs) > 1 else CONST0
                    w = a if (op == OpCode.COPY) else graph.add_gate(op, a, b)
                    for extra in srcs[2:]:  # n-ary primitive: chain
                        w = graph.add_gate(op, w, extra)
                    wires[out] = w
                else:
                    _, out, expr = item
                    wires[out] = _ExprParser(expr, lookup, emit).parse()
                progressed = True
            except KeyError:
                nxt.append(item)
        if not progressed:
            raise ValueError(f"unresolvable statements (cycle?): {nxt[:3]}")
        remaining = nxt

    graph.set_outputs(wires[o] for o in outputs)
    return graph


_OP_NAMES = {int(v): k for k, v in _PRIMS.items()}


def emit_verilog(graph: LogicGraph) -> str:
    """Emit the graph back as gate-level Verilog (round-trip tested).

    Graph names are free-form (partitioning emits ``<name>.part``, flows
    emit ``hidden-stack``); they are sanitized into legal Verilog
    identifiers here.
    """
    name = re.sub(r"[^A-Za-z0-9_$]", "_", graph.name) or "ffcl"
    if not re.match(r"[A-Za-z_]", name):
        name = f"m_{name}"
    ins = [f"i{k}" for k in range(graph.n_inputs)]
    outs = [f"o{k}" for k in range(graph.n_outputs)]
    lines = [f"module {name}({', '.join(ins + outs)});"]
    if ins:
        lines.append(f"  input {', '.join(ins)};")
    if outs:
        lines.append(f"  output {', '.join(outs)};")
    names = {CONST0: "1'b0", CONST1: "1'b1"}
    for i in range(graph.n_inputs):
        names[graph.input_wire(i)] = ins[i]
    gate_wires = [f"w{j}" for j in range(graph.n_gates)]
    if gate_wires:
        lines.append(f"  wire {', '.join(gate_wires)};")
    base = graph.first_gate_wire
    for j, (op, a, b) in enumerate(graph.gates):
        names[base + j] = gate_wires[j]
        if OpCode(op) == OpCode.NOP:
            # NOP gates produce constant 0 on their wire (gate_ir semantics);
            # structural Verilog has no nop primitive, so emit the constant.
            lines.append(f"  buf g{j} ({gate_wires[j]}, 1'b0);")
            continue
        prim = _OP_NAMES[int(op)]
        if OpCode(op) in (OpCode.NOT, OpCode.COPY):
            lines.append(f"  {prim} g{j} ({gate_wires[j]}, {names[a]});")
        else:
            lines.append(
                f"  {prim} g{j} ({gate_wires[j]}, {names[a]}, {names[b]});")
    for k, o in enumerate(graph.outputs):
        lines.append(f"  assign {outs[k]} = {names[o]};")
    lines.append("endmodule")
    return "\n".join(lines)
