# Copied from src/repro/core/verify.py; only the repro imports differ.
"""Static schedule verifier: dataflow proofs over compiled programs.

Differential execution is a weak oracle for a scheduled Boolean program:
a read of uninitialized scratch that happens to be zero, or a NOP lane
aimed at a live row, passes every parity test today and only breaks
later (different batch width, different allocator, different stage
order).  This module *proves* the structural invariants of
:class:`~repro.core.scheduler.LogicProgram` /
:class:`~repro.core.scheduler.MegaProgram` statically — no execution,
no input data — and reports violations as typed :class:`Diagnostic`
records with exact ``(stage, step, lane, addr)`` locations (DESIGN.md
§13).

Two analysis layers:

  * **structural** (program-only): stream shapes and dtypes, address
    bounds, the kernel input-scatter contract (inputs at rows
    ``2..1+n_inputs``), trash-row discipline, per-step write conflicts,
    opcode-homogeneity metadata, and the eq. 23 step-count envelope.
  * **symbolic** (graph-aware when a reference
    :class:`~repro.core.gate_ir.LogicGraph` is supplied): the streams
    are executed over hash-consed *terms* instead of bits — every row
    holds the term it was last written, reads of never-written rows are
    use-before-def, and every lane's computed term must exist in the
    reference graph's term set.  Terms are uninterpreted (no algebraic
    identities), so the check is conservative: any operand swap,
    liveness clobber, or retargeted write that changes the dataflow
    changes the term and is flagged, at the first lane that observes it
    and again at the final output comparison.

Rule-code vocabulary (CLOSED — new checks must reuse or extend here,
tests pin the set):

=====  ====================================================================
code   meaning
=====  ====================================================================
V101   stream shape / dtype / metadata-length / opcode-range violation
V102   address out of ``[0, n_addr)``
V103   I/O interface contract (``input_addrs != arange(2, 2+n_inputs)``,
       output arity mismatch, graph/program interface disagreement)
V104   trash-row discipline (trash aliases const/input/output rows,
       non-NOP lane writes trash, live lane reads trash)
V105   use-before-def (effective read of a never-written row)
V106   write conflict (two live lanes write one row in the same step)
V107   opcode-homogeneity metadata disagrees with the streams
V108   capacity contract (live-lane count != n_gates, step count outside
       the ``ceil(n_gates/n_unit) <= n_steps <= eq. 23`` envelope)
V109   dataflow mismatch: a live lane computes a term outside the
       reference graph's term set
V110   output mismatch: an output row's final term differs from the
       graph's output wire term
V111   megaprogram stage_meta / stream-slice / padding-lane corruption
V112   stage-handoff: output-gather row undefined by its stage's stream,
       or chained stage width mismatch
V113   scratch coverage: a stage addresses beyond the shared mega buffer
V114   output permutation is not a bijection
V115   pass-pipeline remap certificate failure (not total on outputs,
       out of range, constants/inputs not fixed, outputs not remapped)
=====  ====================================================================

Entry points: :func:`verify_program`, :func:`verify_megaprogram`,
:func:`verify_artifact`, :func:`certify_remap`; all return a
:class:`VerifyReport` (or a diagnostic list for the remap certificate).
The ``verify=`` knob of :class:`~repro.core.spec.CompileSpec` wires
these through the compile (``"compile"``), store-load (``"load"``), or
both (``"full"``) paths; see DESIGN.md §13 for the knob contract.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.errors import PermanentCompileError
from repro_torch.core.gate_ir import CONST0, LogicGraph, OpCode
from repro_torch.core.levelize import levelize

RULE_CODES = (
    "V101", "V102", "V103", "V104", "V105", "V106", "V107", "V108",
    "V109", "V110", "V111", "V112", "V113", "V114", "V115",
)

# symbolic row states that are not interned terms
_UNDEF = -1          # row never written (and not an initial def)
_POISON = -2         # row downstream of an already-reported violation

_N_OPCODES = 9       # NOP..COPY
_UNARY = (int(OpCode.NOT), int(OpCode.COPY))


@dataclass(frozen=True)
class Diagnostic:
    """One verified-false invariant, located as precisely as possible.

    ``stage`` is the megaprogram / pipeline stage index (``None`` for a
    monolithic program), ``step``/``lane`` index into the streams, and
    ``addr`` is the offending buffer row — each ``None`` when the rule
    has no such coordinate (e.g. a shape mismatch).
    """

    code: str
    message: str
    stage: Optional[int] = None
    step: Optional[int] = None
    lane: Optional[int] = None
    addr: Optional[int] = None

    def __str__(self) -> str:
        loc = ",".join(
            f"{k}={v}" for k, v in (("stage", self.stage),
                                    ("step", self.step),
                                    ("lane", self.lane),
                                    ("addr", self.addr)) if v is not None)
        return f"{self.code}[{loc}]: {self.message}" if loc \
            else f"{self.code}: {self.message}"


@dataclass(frozen=True)
class VerifyReport:
    """Outcome of one static verification."""

    target: str                              # what was verified (name)
    diagnostics: tuple[Diagnostic, ...]
    checked: dict = field(default_factory=dict, compare=False)
    elapsed_s: float = field(default=0.0, compare=False)
    truncated: bool = False                  # diagnostic cap hit

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def raise_if_failed(self) -> "VerifyReport":
        if not self.ok:
            raise ScheduleVerificationError(self)
        return self

    def summary(self) -> str:
        if self.ok:
            c = self.checked
            return (f"{self.target}: OK ({c.get('programs', 0)} program(s), "
                    f"{c.get('steps', 0)} steps, {c.get('lanes', 0)} live "
                    f"lanes, {c.get('terms', 0)} terms)")
        head = "; ".join(str(d) for d in self.diagnostics[:4])
        more = len(self.diagnostics) - 4
        tail = f" (+{more} more)" if more > 0 else ""
        trunc = " [truncated]" if self.truncated else ""
        return (f"{self.target}: {len(self.diagnostics)} violation(s)"
                f"{trunc} — {head}{tail}")


class ScheduleVerificationError(PermanentCompileError):
    """A compiled schedule failed static verification.

    ``PermanentCompileError``: retrying cannot fix a structurally wrong
    program — the front door sheds instead of burning its deadline.
    Carries the full :class:`VerifyReport` as ``.report``."""

    def __init__(self, report: VerifyReport):
        super().__init__(report.summary())
        self.report = report


class _Ctx:
    """Diagnostic accumulator with a hard cap (a corrupted stream must
    not produce one diagnostic per lane of a million-lane program)."""

    def __init__(self, max_diagnostics: int):
        self.max = max_diagnostics
        self.diags: list[Diagnostic] = []
        self.truncated = False
        self.checked = {"programs": 0, "steps": 0, "lanes": 0, "terms": 0}

    @property
    def full(self) -> bool:
        return len(self.diags) >= self.max

    def add(self, code: str, message: str, *, stage: Optional[int] = None,
            step: Optional[int] = None, lane: Optional[int] = None,
            addr: Optional[int] = None) -> None:
        if self.full:
            self.truncated = True
            return
        self.diags.append(Diagnostic(code=code, message=message, stage=stage,
                                     step=step, lane=lane, addr=addr))

    def report(self, target: str, t0: float) -> VerifyReport:
        return VerifyReport(target=target, diagnostics=tuple(self.diags),
                            checked=dict(self.checked),
                            elapsed_s=time.perf_counter() - t0,
                            truncated=self.truncated)


# ---------------------------------------------------------------------------
# hash-consed terms
# ---------------------------------------------------------------------------

class _Interner:
    """Hash-consing for symbolic dataflow terms.

    Leaves are ``("c", 0)`` / ``("c", 1)`` (the constant rows) and
    ``("in", i)`` (primary input *i*); a gate application is
    ``(opcode, a_term, b_term)`` (``(opcode, a_term)`` for unary ops),
    **uncanonicalized** — the scheduler preserves operand order exactly,
    so structural equality is the right equivalence.  NOP collapses to
    the constant-0 term and COPY passes its operand through, mirroring
    ``apply_op`` and the graph-interning rules, so a schedule and its
    source graph intern the same ids for the same dataflow.
    """

    def __init__(self) -> None:
        self._ids: dict = {}
        self.c0 = self.intern(("c", 0))
        self.c1 = self.intern(("c", 1))

    def intern(self, key) -> int:
        tid = self._ids.get(key)
        if tid is None:
            tid = len(self._ids)
            self._ids[key] = tid
        return tid

    def __len__(self) -> int:
        return len(self._ids)

    def leaf_inputs(self, n_inputs: int) -> list[int]:
        return [self.intern(("in", i)) for i in range(n_inputs)]

    def apply(self, op: int, ta: int, tb: int) -> int:
        """Term of ``op(ta, tb)``; poison propagates, NOP/COPY collapse."""
        if op == int(OpCode.NOP):
            return self.c0
        if ta == _POISON or (op not in _UNARY and tb == _POISON):
            return _POISON
        if op == int(OpCode.COPY):
            return ta
        if op == int(OpCode.NOT):
            return self.intern((op, ta))
        return self.intern((op, ta, tb))


def graph_terms(graph: LogicGraph, interner: _Interner,
                input_terms: Optional[list[int]] = None
                ) -> tuple[list[int], set[int]]:
    """Intern every wire of ``graph``; returns ``(wire_terms, term_set)``.

    ``input_terms`` substitutes the primary-input leaves (the chain-mode
    handoff: stage *k+1*'s inputs are stage *k*'s output terms); default
    is the fresh ``("in", i)`` leaves.
    """
    if input_terms is None:
        input_terms = interner.leaf_inputs(graph.n_inputs)
    if len(input_terms) != graph.n_inputs:
        raise ValueError(
            f"graph {graph.name!r} expects {graph.n_inputs} input terms, "
            f"got {len(input_terms)}")
    terms = [interner.c0, interner.c1, *input_terms]
    for op, a, b in graph.gates:
        terms.append(interner.apply(int(op), terms[a], terms[b]))
    return terms, set(terms)


# ---------------------------------------------------------------------------
# structural layer (program-only)
# ---------------------------------------------------------------------------

def _flag_oob(ctx: _Ctx, arr: np.ndarray, n_addr: int, what: str,
              stage: Optional[int]) -> bool:
    bad = (arr < 0) | (arr >= n_addr)
    if not bad.any():
        return True
    for s, u in np.argwhere(bad)[:8]:
        ctx.add("V102", f"{what} address {int(arr[s, u])} outside "
                f"[0, {n_addr})", stage=stage, step=int(s), lane=int(u),
                addr=int(arr[s, u]))
    return False


def _check_structure(ctx: _Ctx, p, stage: Optional[int]) -> bool:
    """Program-only invariants.  Returns False when the streams are too
    malformed for the symbolic walk to be meaningful."""
    streams = {"src_a": p.src_a, "src_b": p.src_b, "dst": p.dst,
               "opcode": p.opcode}
    shape = p.src_a.shape
    ok = True
    for name, arr in streams.items():
        if arr.ndim != 2 or arr.shape != shape:
            ctx.add("V101", f"stream {name} shape {arr.shape} != {shape}",
                    stage=stage)
            ok = False
        elif not np.issubdtype(arr.dtype, np.integer):
            ctx.add("V101", f"stream {name} dtype {arr.dtype} is not "
                    "integral", stage=stage)
            ok = False
    if not ok:
        return False
    n_steps, width = shape
    if width != p.n_unit:
        ctx.add("V101", f"lane count {width} != n_unit {p.n_unit}",
                stage=stage)
        ok = False
    for name, arr in (("step_opcode", p.step_opcode),
                      ("homogeneous", p.homogeneous),
                      ("level_of_step", p.level_of_step)):
        if np.asarray(arr).shape != (n_steps,):
            ctx.add("V101", f"{name} length {np.asarray(arr).shape} != "
                    f"({n_steps},)", stage=stage)
            ok = False
    if not ok:
        return False
    if ((p.opcode < 0) | (p.opcode >= _N_OPCODES)).any():
        s, u = np.argwhere((p.opcode < 0) | (p.opcode >= _N_OPCODES))[0]
        ctx.add("V101", f"opcode {int(p.opcode[s, u])} outside "
                f"[0, {_N_OPCODES})", stage=stage, step=int(s), lane=int(u))
        ok = False

    # address bounds (V102)
    for name, arr in (("src_a", p.src_a), ("src_b", p.src_b),
                      ("dst", p.dst)):
        ok &= _flag_oob(ctx, arr, p.n_addr, name, stage)

    # I/O interface (V103): the kernels scatter the input slab at row 2
    # (jax.lax.dynamic_update_slice(buf, inputs, (2, 0))) — input_addrs
    # MUST be exactly rows 2..1+n_inputs or the jitted paths and the
    # numpy oracle disagree.
    want = np.arange(2, 2 + p.n_inputs)
    if not np.array_equal(np.asarray(p.input_addrs), want):
        ctx.add("V103", f"input_addrs {np.asarray(p.input_addrs).tolist()} "
                f"!= rows 2..{1 + p.n_inputs} (kernel scatter contract)",
                stage=stage)
        ok = False
    out_addrs = np.asarray(p.output_addrs)
    if out_addrs.shape != (p.n_outputs,):
        ctx.add("V103", f"output_addrs arity {out_addrs.shape} != "
                f"n_outputs {p.n_outputs}", stage=stage)
        ok = False
    elif ((out_addrs < 0) | (out_addrs >= p.n_addr)).any():
        j = int(np.argwhere((out_addrs < 0) | (out_addrs >= p.n_addr))[0, 0])
        ctx.add("V102", f"output_addrs[{j}] = {int(out_addrs[j])} outside "
                f"[0, {p.n_addr})", stage=stage, addr=int(out_addrs[j]))
        ok = False

    # trash-row discipline (V104): the trash row must be a dedicated
    # scratch row — aliasing a const/input row would let NOP padding
    # clobber live preloads (the exposure build_megaprogram now guards).
    if not (2 + p.n_inputs <= p.trash_addr < p.n_addr):
        ctx.add("V104", f"trash_addr {p.trash_addr} aliases a "
                f"const/input row or exceeds n_addr {p.n_addr}",
                stage=stage, addr=int(p.trash_addr))
        ok = False
    elif out_addrs.shape == (p.n_outputs,) and \
            (out_addrs == p.trash_addr).any():
        j = int(np.argwhere(out_addrs == p.trash_addr)[0, 0])
        ctx.add("V104", f"output_addrs[{j}] reads the trash row",
                stage=stage, addr=int(p.trash_addr))
        ok = False
    if not ok:
        return False

    nontrash = p.dst != p.trash_addr
    live = (p.opcode != int(OpCode.NOP)) | nontrash    # not pure padding
    bad = ~nontrash & (p.opcode != int(OpCode.NOP))
    if bad.any():
        for s, u in np.argwhere(bad)[:4]:
            ctx.add("V104", f"non-NOP lane (opcode "
                    f"{int(p.opcode[s, u])}) writes the trash row",
                    stage=stage, step=int(s), lane=int(u),
                    addr=int(p.trash_addr))

    # capacity accounting (V108)
    n_live = int(live.sum())
    if n_live != p.n_gates:
        ctx.add("V108", f"live lane count {n_live} != n_gates "
                f"{p.n_gates}", stage=stage)
    min_steps = -(-p.n_gates // max(1, p.n_unit))
    if n_steps < min_steps:
        ctx.add("V108", f"n_steps {n_steps} < ceil(n_gates/n_unit) = "
                f"{min_steps}", stage=stage)

    # homogeneity metadata (V107) — recomputed with the scheduler's
    # exact rule: opcode-0 lanes must be pure padding for a non-NOP
    # specialized slab op to be safe.
    if n_steps:
        mx = p.opcode.max(axis=1)
        mn = np.where(p.opcode == 0, np.int32(127), p.opcode).min(axis=1)
        pad_only = ((p.opcode != 0) | ~nontrash).all(axis=1)
        homog = (mx == 0) | ((mx == mn) & pad_only)
        step_op = np.where(homog, mx, 0)
        bad_h = (np.asarray(p.homogeneous, dtype=bool) != homog) | \
            (np.asarray(p.step_opcode) != step_op)
        for s in np.nonzero(bad_h)[0][:4]:
            ctx.add("V107", f"homogeneous={bool(p.homogeneous[s])}/"
                    f"step_opcode={int(p.step_opcode[s])} but streams say "
                    f"{bool(homog[s])}/{int(step_op[s])}",
                    stage=stage, step=int(s))

    # per-step write conflicts among live lanes (V106)
    for s in range(n_steps):
        drow = p.dst[s][live[s]]
        if len(drow) != len(np.unique(drow)):
            vals, counts = np.unique(drow, return_counts=True)
            for a in vals[counts > 1][:2]:
                ctx.add("V106", f"{int(counts[vals == a][0])} live lanes "
                        f"write row {int(a)} in one step",
                        stage=stage, step=s, addr=int(a))
    ctx.checked["steps"] += n_steps
    ctx.checked["lanes"] += n_live
    return True


# ---------------------------------------------------------------------------
# symbolic layer (graph-aware when term_set is given)
# ---------------------------------------------------------------------------

def _sym_execute(ctx: _Ctx, p, interner: _Interner,
                 input_terms: list[int], term_set: Optional[set[int]],
                 stage: Optional[int]) -> list[int]:
    """Walk the streams over terms; returns the output-row terms.

    Per step, all reads happen before all writes (the kernel contract),
    and duplicate writes resolve last-lane-wins (the numpy oracle's
    scatter semantics).  ``term_set`` enables the foreign-term check
    (V109); without it the walk still proves def-before-use (V105) and
    trash isolation (V104).
    """
    rows = np.full(p.n_addr, _UNDEF, dtype=np.int64)
    rows[0], rows[1] = interner.c0, interner.c1
    rows[np.asarray(p.input_addrs)] = input_terms
    trash = p.trash_addr
    nop = int(OpCode.NOP)
    live = (p.opcode != nop) | (p.dst != trash)
    lanes_of = [np.nonzero(live[s])[0] for s in range(p.src_a.shape[0])]

    def _read(a: int, s: int, u: int) -> int:
        t = int(rows[a])
        if a == trash:
            ctx.add("V104", "live lane reads the trash row",
                    stage=stage, step=s, lane=u, addr=int(a))
            return _POISON
        if t == _UNDEF:
            ctx.add("V105", f"read of row {int(a)} before any write",
                    stage=stage, step=s, lane=u, addr=int(a))
            return _POISON
        return t

    for s, lanes in enumerate(lanes_of):
        writes: list[tuple[int, int]] = []
        for u in lanes:
            op = int(p.opcode[s, u])
            if op == nop:              # real NOP gate: reads nothing
                writes.append((int(p.dst[s, u]), interner.c0))
                continue
            ta = _read(int(p.src_a[s, u]), s, int(u))
            tb = interner.c0 if op in _UNARY \
                else _read(int(p.src_b[s, u]), s, int(u))
            t = interner.apply(op, ta, tb)
            if t != _POISON and term_set is not None and t not in term_set:
                ctx.add("V109", "lane computes a term absent from the "
                        "reference graph (operand swapped or clobbered)",
                        stage=stage, step=s, lane=int(u),
                        addr=int(p.dst[s, u]))
                t = _POISON
            writes.append((int(p.dst[s, u]), t))
        for a, t in writes:            # last-lane-wins, after all reads
            rows[a] = t
        if ctx.full:
            break

    outs = []
    for j, a in enumerate(np.asarray(p.output_addrs)):
        t = int(rows[a])
        if t == _UNDEF:
            ctx.add("V105", f"output {j} reads row {int(a)} that was "
                    "never written", stage=stage, addr=int(a))
            t = _POISON
        outs.append(t)
    ctx.checked["terms"] = len(interner)
    return outs


def _verify_one(ctx: _Ctx, p, graph: Optional[LogicGraph],
                interner: _Interner, input_terms: Optional[list[int]],
                stage: Optional[int]) -> Optional[list[int]]:
    """Full (structural + symbolic) verification of one program.
    Returns its output terms, or ``None`` when the structure was too
    broken to walk."""
    ctx.checked["programs"] += 1
    term_set = None
    expected = None
    if graph is not None:
        if (graph.n_inputs, graph.n_outputs) != (p.n_inputs, p.n_outputs):
            ctx.add("V103", f"graph interface ({graph.n_inputs} in, "
                    f"{graph.n_outputs} out) != program ({p.n_inputs} in, "
                    f"{p.n_outputs} out)", stage=stage)
            graph = None
    if not _check_structure(ctx, p, stage):
        return None
    if input_terms is None:
        input_terms = interner.leaf_inputs(p.n_inputs)
    if graph is not None:
        wire_terms, term_set = graph_terms(graph, interner, input_terms)
        expected = [wire_terms[w] for w in graph.outputs]
        # eq. 23 envelope: levelized layout is the upper bound (fusion
        # only shrinks it)
        lv = levelize(graph)
        bound = int((-(-lv.histogram() // p.n_unit)).sum())
        if p.n_steps > bound:
            ctx.add("V108", f"n_steps {p.n_steps} exceeds the eq. 23 "
                    f"bound {bound} for n_unit={p.n_unit}", stage=stage)
    outs = _sym_execute(ctx, p, interner, input_terms, term_set, stage)
    if expected is not None:
        for j, (got, want) in enumerate(zip(outs, expected)):
            if got != _POISON and got != want:
                ctx.add("V110", f"output {j} computes a different term "
                        "than the graph's output wire", stage=stage,
                        addr=int(np.asarray(p.output_addrs)[j]))
    return outs


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def verify_program(prog, graph: Optional[LogicGraph] = None, *,
                   max_diagnostics: int = 64) -> VerifyReport:
    """Statically verify one :class:`LogicProgram`.

    Program-only invariants always run; pass the (post-optimization)
    source ``graph`` to additionally prove the schedule computes exactly
    the graph's dataflow (V109/V110) and respects the eq. 23 step
    envelope.
    """
    t0 = time.perf_counter()
    ctx = _Ctx(max_diagnostics)
    _verify_one(ctx, prog, graph, _Interner(), None, None)
    return ctx.report(getattr(prog, "name", "program"), t0)


def _check_perm(ctx: _Ctx, perm: np.ndarray, n: int) -> bool:
    perm = np.asarray(perm)
    if perm.shape != (n,) or \
            not np.array_equal(np.sort(perm), np.arange(n)):
        ctx.add("V114", f"output_perm is not a permutation of range({n})")
        return False
    return True


def verify_megaprogram(mega, graph: Optional[LogicGraph] = None, *,
                       stage_graphs: Optional[list] = None,
                       max_diagnostics: int = 64) -> VerifyReport:
    """Statically verify a :class:`MegaProgram` against its stages.

    Proves the flattening itself (stage_meta partitions the step axis,
    stream slices match the stage programs, padding lanes only write
    their owning stage's trash row, per-stage scratch fits the shared
    buffer) and then each stage program; with ``graph`` (the composed
    graph for chains, the full post-opt graph for parallel pipelines)
    the stage handoff / reassembly dataflow is proven end to end.

    ``stage_graphs`` (parallel mode) supplies each stage's OWN reference
    graph — required when the partitioner re-optimized its clusters:
    the rewritten cones are semantically equal but structurally
    different from the full graph, so uninterpreted terms must be
    compared per cluster (the cluster graphs themselves are tied back
    to the full graph by the deterministic re-derivation in
    :func:`verify_artifact` plus the pass certificates).
    """
    t0 = time.perf_counter()
    ctx = _Ctx(max_diagnostics)
    stages = tuple(mega.stages)
    if mega.mode not in ("chain", "parallel"):
        ctx.add("V111", f"unknown mega mode {mega.mode!r}")
        return ctx.report(mega.name, t0)
    if len(mega.stage_meta) != len(stages):
        ctx.add("V111", f"stage_meta has {len(mega.stage_meta)} entries "
                f"for {len(stages)} stages")
        return ctx.report(mega.name, t0)

    # stage_meta must partition the step axis and index the gather
    step_lo = out_lo = 0
    meta_ok = True
    for k, (p, meta) in enumerate(zip(stages, mega.stage_meta)):
        lo, hi, n_in, n_out, olo = meta
        if (lo, hi) != (step_lo, step_lo + p.n_steps):
            ctx.add("V111", f"stage_meta step range ({lo}, {hi}) != "
                    f"({step_lo}, {step_lo + p.n_steps})", stage=k)
            meta_ok = False
        if (n_in, n_out) != (p.n_inputs, p.n_outputs):
            ctx.add("V111", f"stage_meta widths ({n_in}, {n_out}) != "
                    f"stage ({p.n_inputs}, {p.n_outputs})", stage=k)
            meta_ok = False
        if olo != out_lo:
            ctx.add("V111", f"stage_meta out_lo {olo} != {out_lo}", stage=k)
            meta_ok = False
        if p.n_addr > mega.n_addr:
            ctx.add("V113", f"stage n_addr {p.n_addr} exceeds the shared "
                    f"scratch buffer ({mega.n_addr} rows)", stage=k)
        if p.n_unit > mega.n_unit:
            ctx.add("V111", f"stage n_unit {p.n_unit} exceeds the padded "
                    f"lane width {mega.n_unit}", stage=k)
            meta_ok = False
        step_lo += p.n_steps
        out_lo += p.n_outputs
    if mega.total_steps != step_lo:
        ctx.add("V111", f"total_steps {mega.total_steps} != sum of stage "
                f"steps {step_lo}")
        meta_ok = False
    if len(np.asarray(mega.out_addrs)) != out_lo:
        ctx.add("V111", f"out_addrs has {len(np.asarray(mega.out_addrs))} "
                f"entries, stages produce {out_lo}")
        meta_ok = False

    if meta_ok:
        for k, (p, meta) in enumerate(zip(stages, mega.stage_meta)):
            lo, hi, _, _, olo = meta
            w = p.n_unit
            for name in ("src_a", "src_b", "dst", "opcode"):
                if not np.array_equal(getattr(mega, name)[lo:hi, :w],
                                      getattr(p, name)):
                    ctx.add("V111", f"mega stream {name} slice differs "
                            "from the stage program", stage=k)
            # padding lanes: NOP writing the owning stage's trash row only
            padc = mega.opcode[lo:hi, w:]
            padd = mega.dst[lo:hi, w:]
            if padc.size and (padc != int(OpCode.NOP)).any():
                s, u = np.argwhere(padc != int(OpCode.NOP))[0]
                ctx.add("V111", "padding lane carries a non-NOP opcode",
                        stage=k, step=int(lo + s), lane=int(w + u))
            if padd.size and (padd != p.trash_addr).any():
                s, u = np.argwhere(padd != p.trash_addr)[0]
                ctx.add("V104", f"padding lane writes row "
                        f"{int(padd[s, u])} instead of the stage trash "
                        f"row {p.trash_addr}", stage=k, step=int(lo + s),
                        lane=int(w + u), addr=int(padd[s, u]))
            if not np.array_equal(mega.step_trash[lo:hi],
                                  np.full(hi - lo, p.trash_addr)):
                ctx.add("V111", "step_trash does not name the owning "
                        f"stage's trash row {p.trash_addr}", stage=k)
            if not np.array_equal(mega.step_branch[lo:hi], p.step_branch):
                ctx.add("V107", "mega step_branch differs from the stage "
                        "program's dispatch metadata", stage=k)
            if not np.array_equal(
                    np.asarray(mega.out_addrs[olo:olo + p.n_outputs]),
                    np.asarray(p.output_addrs)):
                ctx.add("V112", "out_addrs gather slice differs from the "
                        "stage's output_addrs", stage=k)

    # handoff widths + permutation
    if mega.mode == "chain":
        for k in range(len(stages) - 1):
            if stages[k].n_outputs != stages[k + 1].n_inputs:
                ctx.add("V112", f"stage {k} produces "
                        f"{stages[k].n_outputs} outputs, stage {k + 1} "
                        f"expects {stages[k + 1].n_inputs} inputs",
                        stage=k)
        if stages and stages[0].n_inputs != mega.n_inputs:
            ctx.add("V112", f"mega n_inputs {mega.n_inputs} != first "
                    f"stage's {stages[0].n_inputs}", stage=0)
        if not _check_perm(ctx, mega.output_perm, mega.n_outputs):
            pass
        elif not np.array_equal(np.asarray(mega.output_perm),
                                np.arange(mega.n_outputs)):
            ctx.add("V114", "chain-mode output_perm must be the identity")
    else:
        for k, p in enumerate(stages):
            if p.n_inputs != mega.n_inputs:
                ctx.add("V112", f"parallel stage reads {p.n_inputs} "
                        f"inputs, pipeline advertises {mega.n_inputs}",
                        stage=k)
        _check_perm(ctx, mega.output_perm, mega.n_outputs)

    # per-stage programs (+ end-to-end dataflow when a graph is given)
    interner = _Interner()
    chainable = graph is not None and not ctx.diags
    if mega.mode == "chain":
        terms = interner.leaf_inputs(mega.n_inputs)
        gterm_set: Optional[set[int]] = None
        expected = None
        if chainable and graph.n_inputs == mega.n_inputs:
            wire_terms, gterm_set = graph_terms(graph, interner)
            expected = [wire_terms[w] for w in graph.outputs]
        for k, p in enumerate(stages):
            if terms is None or len(terms) != p.n_inputs or \
                    any(t == _POISON for t in terms):
                terms = None           # handoff already diagnosed; walk
                ctx.checked["programs"] += 1  # structurally only
                _check_structure(ctx, p, k)
                continue
            outs = _verify_one(ctx, p, None, interner, terms, k)
            if outs is not None and gterm_set is not None:
                # stage gates must land inside the composed graph's terms
                for j, t in enumerate(outs):
                    if t != _POISON and t not in gterm_set:
                        ctx.add("V109", f"stage output {j} computes a "
                                "term absent from the composed graph",
                                stage=k)
            terms = outs
        if expected is not None and terms is not None:
            for j, (got, want) in enumerate(zip(terms, expected)):
                if got != _POISON and got != want:
                    ctx.add("V110", f"pipeline output {j} computes a "
                            "different term than the composed graph")
    elif stage_graphs is not None and len(stage_graphs) == len(stages):
        # re-optimized clusters: prove each stage against its OWN graph
        leaf = interner.leaf_inputs(mega.n_inputs)
        for k, (p, sg) in enumerate(zip(stages, stage_graphs)):
            ins = leaf if sg.n_inputs == mega.n_inputs \
                else interner.leaf_inputs(sg.n_inputs)
            _verify_one(ctx, p, sg, interner, ins, k)
    else:
        leaf = interner.leaf_inputs(mega.n_inputs)
        gterm_set = None
        expected = None
        if chainable and graph.n_inputs == mega.n_inputs:
            wire_terms, gterm_set = graph_terms(graph, interner)
            expected = [wire_terms[w] for w in graph.outputs]
        cat: list[int] = []
        for k, p in enumerate(stages):
            ins = leaf if p.n_inputs == mega.n_inputs \
                else interner.leaf_inputs(p.n_inputs)
            outs = _verify_one(ctx, p, None, interner, ins, k)
            if outs is not None and gterm_set is not None:
                for t in outs:
                    if t not in (_POISON, _UNDEF) and t not in gterm_set:
                        ctx.add("V109", "partition output computes a term "
                                "absent from the full graph", stage=k)
                        break
            cat.extend(outs if outs is not None
                       else [_POISON] * p.n_outputs)
        if expected is not None and len(cat) == mega.n_outputs and \
                _check_perm(_Ctx(1), mega.output_perm, mega.n_outputs):
            perm = np.asarray(mega.output_perm)
            for j in range(mega.n_outputs):
                got = cat[int(perm[j])]
                if got != _POISON and got != expected[j]:
                    ctx.add("V110", f"re-assembled output {j} computes a "
                            "different term than the graph")
    return ctx.report(mega.name, t0)


def verify_artifact(artifact, *, include_mega: bool = True,
                    parts=None, max_diagnostics: int = 64) -> VerifyReport:
    """Statically verify a whole
    :class:`~repro.core.compiler.CompiledArtifact` against its own
    post-optimization graph — the check the ``verify=`` knob runs at
    compile and store-load time.

    Monolithic artifacts verify the one program against the graph;
    parallel (partitioned) artifacts verify every part over the shared
    primary-input leaves and the permuted re-assembly; chain artifacts
    verify the stage handoff against the composed graph.  With
    ``include_mega`` (default), multi-program artifacts additionally
    verify their flattened :class:`MegaProgram` — the form the engine
    actually serves.

    ``parts`` (compile path only): the partition results the caller just
    scheduled the programs from.  Supplying them skips the deterministic
    partition *re-derivation* — which re-runs per-cluster optimization
    and would otherwise nearly double a partitioned compile — while
    every per-program dataflow proof still runs in full against those
    cluster graphs.  On the load path leave it ``None``: re-deriving the
    clustering from ``(graph, spec)`` is the trust anchor there, since a
    store entry's programs cannot vouch for themselves.
    """
    t0 = time.perf_counter()
    ctx = _Ctx(max_diagnostics)
    graph = artifact.graph
    programs = tuple(artifact.programs)
    mode = getattr(artifact, "mode", "parallel")
    if not programs:
        ctx.add("V101", "artifact has no programs")
        return ctx.report(graph.name, t0)
    spec = getattr(artifact, "spec", None)
    if spec is not None and spec.resolved:
        for k, p in enumerate(programs):
            if p.n_unit != spec.n_unit:
                ctx.add("V101", f"program n_unit {p.n_unit} != spec "
                        f"n_unit {spec.n_unit}",
                        stage=None if len(programs) == 1 else k)

    interner = _Interner()
    parts_graphs: Optional[list[LogicGraph]] = None
    if mode == "chain":
        terms: Optional[list[int]] = interner.leaf_inputs(
            programs[0].n_inputs)
        gterm_set = None
        expected = None
        if graph.n_inputs == programs[0].n_inputs:
            wire_terms, gterm_set = graph_terms(graph, interner)
            expected = [wire_terms[w] for w in graph.outputs]
        else:
            ctx.add("V103", f"graph reads {graph.n_inputs} inputs, first "
                    f"stage {programs[0].n_inputs}")
        for k, p in enumerate(programs):
            if terms is None or len(terms) != p.n_inputs:
                ctx.add("V112", f"stage {k} expects {p.n_inputs} inputs, "
                        f"handoff provides "
                        f"{'?' if terms is None else len(terms)}", stage=k)
                _check_structure(ctx, p, k)
                ctx.checked["programs"] += 1
                terms = None
                continue
            outs = _verify_one(ctx, p, None, interner, terms, k)
            if outs is not None and gterm_set is not None:
                for j, t in enumerate(outs):
                    if t not in (_POISON, _UNDEF) and t not in gterm_set:
                        ctx.add("V109", f"stage output {j} computes a "
                                "term absent from the composed graph",
                                stage=k)
            terms = outs
        if expected is not None and terms is not None:
            for j, (got, want) in enumerate(zip(terms, expected)):
                if got != _POISON and got != want:
                    ctx.add("V110", f"pipeline output {j} computes a "
                            "different term than the composed graph")
        _check_perm(ctx, artifact.output_perm, graph.n_outputs)
    elif len(programs) == 1:
        _verify_one(ctx, programs[0], graph, interner, None, None)
        _check_perm(ctx, artifact.output_perm, graph.n_outputs)
    else:
        # Partitioned pipeline.  The partitioner may have RE-OPTIMIZED
        # each cluster cone (compiler.compile passes the full spec), so
        # the programs' terms are structurally different from the full
        # graph's.  Partitioning is deterministic in (graph, spec):
        # re-derive the cluster graphs and prove each program against
        # its own cluster (V110 per part), the recorded permutation
        # against the re-derived clustering (V114), and leave
        # cluster == cone semantics to the certified pass pipeline.
        if parts is None and spec is not None and \
                getattr(spec, "max_gates", None) is not None:
            from repro_torch.core.partition import partition
            try:
                parts = partition(graph, spec.with_(verify="off"))
            except Exception as exc:        # noqa: BLE001 — any failure
                ctx.add("V111", "partition re-derivation failed: "
                        f"{exc!r}")        # to re-derive is a finding
                parts = None
        if spec is not None and getattr(spec, "max_gates", None) is not None:
            from repro_torch.core.partition import output_permutation
            if parts is not None:
                if len(parts) != len(programs):
                    ctx.add("V111", f"re-derived partitioning has "
                            f"{len(parts)} clusters, artifact has "
                            f"{len(programs)} programs")
                else:
                    parts_graphs = [q.graph for q in parts]
                    want = output_permutation(parts, graph.n_outputs)
                    if not np.array_equal(np.asarray(artifact.output_perm),
                                          want):
                        ctx.add("V114", "output_perm differs from the "
                                "re-derived partition permutation")
        leaf = interner.leaf_inputs(graph.n_inputs)
        if parts_graphs is not None:
            for k, (p, sg) in enumerate(zip(programs, parts_graphs)):
                ins = leaf if sg.n_inputs == graph.n_inputs \
                    else interner.leaf_inputs(sg.n_inputs)
                _verify_one(ctx, p, sg, interner, ins, k)
            _check_perm(ctx, artifact.output_perm, graph.n_outputs)
        else:
            wire_terms, gterm_set = graph_terms(graph, interner)
            expected = [wire_terms[w] for w in graph.outputs]
            cat: list[int] = []
            for k, p in enumerate(programs):
                if p.n_inputs != graph.n_inputs:
                    ctx.add("V103", f"partition reads {p.n_inputs} inputs, "
                            f"graph has {graph.n_inputs}", stage=k)
                    cat.extend([_POISON] * p.n_outputs)
                    continue
                outs = _verify_one(ctx, p, None, interner, leaf, k)
                if outs is None:
                    cat.extend([_POISON] * p.n_outputs)
                    continue
                for t in outs:
                    if t not in (_POISON, _UNDEF) and t not in gterm_set:
                        ctx.add("V109", "partition output computes a term "
                                "absent from the full graph", stage=k)
                        break
                cat.extend(outs)
            if _check_perm(ctx, artifact.output_perm, graph.n_outputs) and \
                    len(cat) == graph.n_outputs:
                perm = np.asarray(artifact.output_perm)
                for j in range(graph.n_outputs):
                    got = cat[int(perm[j])]
                    if got != _POISON and got != expected[j]:
                        ctx.add("V110", f"re-assembled output {j} computes "
                                "a different term than the graph")

    if include_mega and len(programs) > 1 and not ctx.full:
        sub = verify_megaprogram(artifact.megaprogram(),
                                 None if parts_graphs is not None else graph,
                                 stage_graphs=parts_graphs,
                                 max_diagnostics=max_diagnostics
                                 - len(ctx.diags))
        seen = set(ctx.diags)
        for d in sub.diagnostics:
            if d not in seen:
                ctx.diags.append(d)
        ctx.truncated |= sub.truncated
        for k in ("steps", "lanes"):
            ctx.checked[k] += sub.checked.get(k, 0)
    return ctx.report(graph.name, t0)


# ---------------------------------------------------------------------------
# pass-pipeline remap certificates
# ---------------------------------------------------------------------------

def certify_remap(old_graph: LogicGraph, new_graph: LogicGraph,
                  remap: np.ndarray, *,
                  label: str = "remap") -> list[Diagnostic]:
    """Certify one old-wire -> new-wire map (a :class:`PassResult` or a
    composed :class:`OptResult` remap) against its endpoint graphs.

    The certificate (all V115): the map covers every old wire, keeps
    constants and primary inputs fixed (passes must not touch the I/O
    interface), lands every live wire inside the new graph, and maps the
    old outputs exactly onto the new outputs in order — i.e. it composes
    to a *total, in-range output map*.  Dropped gates (``-1``) are legal
    anywhere else.
    """
    diags: list[Diagnostic] = []
    remap = np.asarray(remap)
    if remap.shape != (old_graph.n_wires,):
        diags.append(Diagnostic(
            "V115", f"{label}: shape {remap.shape} != "
            f"({old_graph.n_wires},)"))
        return diags
    fixed = np.arange(old_graph.first_gate_wire)
    if old_graph.n_inputs != new_graph.n_inputs:
        diags.append(Diagnostic(
            "V115", f"{label}: input arity changed "
            f"({old_graph.n_inputs} -> {new_graph.n_inputs})"))
    elif not np.array_equal(remap[:len(fixed)], fixed):
        diags.append(Diagnostic(
            "V115", f"{label}: constants/primary inputs are not mapped "
            "to themselves"))
    live = remap >= CONST0
    if live.any() and int(remap[live].max()) >= new_graph.n_wires:
        w = int(np.argwhere(live & (remap >= new_graph.n_wires))[0, 0])
        diags.append(Diagnostic(
            "V115", f"{label}: wire {w} maps to {int(remap[w])} outside "
            f"the new graph ({new_graph.n_wires} wires)", addr=w))
    outs = np.asarray(old_graph.outputs, dtype=np.int64)
    if len(outs):
        mapped = remap[outs]
        if (mapped < 0).any():
            j = int(np.argwhere(mapped < 0)[0, 0])
            diags.append(Diagnostic(
                "V115", f"{label}: output {j} (wire {int(outs[j])}) was "
                "dropped — the map is not total on outputs", addr=int(
                    outs[j])))
        elif not np.array_equal(mapped,
                                np.asarray(new_graph.outputs,
                                           dtype=np.int64)):
            diags.append(Diagnostic(
                "V115", f"{label}: remapped outputs differ from the new "
                "graph's output list"))
    return diags


def effective_mode(spec_verify: str, default: Optional[str]) -> str:
    """The verify mode one compile/load should run at: the spec's
    opt-in wins; a compiler/store-level default applies otherwise."""
    if spec_verify != "off":
        return spec_verify
    return default or "off"
