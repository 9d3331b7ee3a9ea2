# Copied from src/repro/core/scheduler.py; only the repro imports differ.
"""Sub-kernel decomposition + memory/opcode assignment (paper §6.1, eq. 23).

Turns a levelized :class:`LogicGraph` into a :class:`LogicProgram` — the
flat address/opcode streams that drive the time-shared compute units.

Scheduling pipeline (DESIGN.md §1): [optimize ->] levelize -> opcode-sort
-> fuse -> address-alloc -> emit (the optional first stage is the
gate-level pass pipeline of core/opt.py, DESIGN.md §7, via the
``optimize=`` knob of :func:`compile_graph`):

  * each logic level with ``n_l`` gates on a fabric with ``n_unit`` units is
    split into ``ceil(n_l / n_unit)`` *sub-kernel steps* (eq. 23);
  * **opcode sorting** (``opcode_sort=True``): gates inside a level are
    stably sorted by opcode before slicing, so most steps are
    *opcode-homogeneous* — every active unit runs the same bitwise op.
    Homogeneous steps carry a per-step ``step_opcode`` scalar and dispatch
    through one specialized slab op in the kernels instead of the 8-way
    chained opcode select (DESIGN.md §1.2);
  * **step fusion** (``fuse_levels=True``): capacity-constrained ASAP list
    scheduling across levels — a gate may join any earlier,
    partially-occupied step as long as every operand was produced at a
    strictly earlier step. This merges (parts of) consecutive levels into
    shared steps and shrinks ``n_steps`` — the ``fori_loop`` trip count and
    the N_subkernel term of eq. 23 — below the eq. 23 value whenever level
    sizes are ragged modulo ``n_unit`` (DESIGN.md §1.3);
  * every wire gets an address in the data buffer; per step, unit ``u`` reads
    ``buf[src_a[s,u]]`` and ``buf[src_b[s,u]]``, applies ``opcode[s,u]``, and
    writes ``buf[dst[s,u]]`` (paper Tables 2/3: Addr. Mem. Buf. holds
    [2 reads + 1 write] per unit, Opcode Buf. one opcode per unit);
  * NOP padding fills partially-occupied steps (paper: "[AND, NOP]"); NOP
    writes target a dedicated trash address so scatters stay unconditional.

Address allocation strategies:
  * ``direct``   — paper-faithful: address == wire id; buffer holds every
    wire (paper §6.3: "total size of the data vector buffer ... is the total
    number of nodes of the DAG").
  * ``liveness`` — beyond-paper: register-allocation-style address reuse.
    A wire's slot is freed after its last reader's step; freed slots become
    reusable the *next* step (within a step, all reads precede all writes,
    but a same-step reuse of a freed slot by another unit's write is still a
    WAR hazard across units only if a reader in the same step uses it — we
    conservatively release at step+1). Cuts the VMEM working set by the
    live-range profile (often 5-20x for deep graphs) which directly shrinks
    the memory roofline term of the logic kernel.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import calibrate as _calibrate
from repro_torch.core.gate_ir import (CONST0, CONST1, LogicGraph, MIXED_DISPATCH,
                                OpCode, apply_op)
from repro_torch.core.levelize import Levelization, levelize
from repro_torch.core.spec import CompileSpec, resolve_spec, _UNSET
from repro_torch.core import packing


@dataclass(frozen=True)
class LogicProgram:
    """Compiled FFCL module: the address/opcode streams + buffer layout."""

    # streams, all (n_steps, n_unit) int32
    src_a: np.ndarray
    src_b: np.ndarray
    dst: np.ndarray
    opcode: np.ndarray
    # per-step dispatch metadata (opcode-homogeneous scheduling)
    step_opcode: np.ndarray     # (n_steps,) int32; the shared opcode where
                                # homogeneous, 0 for mixed steps
    homogeneous: np.ndarray     # (n_steps,) bool; True iff all non-NOP units
                                # in the step run the same opcode
    # buffer layout
    n_addr: int                 # data-buffer rows (incl. consts + trash)
    trash_addr: int
    input_addrs: np.ndarray     # (n_inputs,) address of each primary input
    output_addrs: np.ndarray    # (n_outputs,)
    # provenance / stats
    n_inputs: int
    n_outputs: int
    n_gates: int
    depth: int
    level_of_step: np.ndarray   # (n_steps,) highest logic level in each step
    n_unit: int
    name: str = "ffcl"

    #: array-valued fields, in the canonical serialization order — the
    #: persistence contract of core/artifact_store.py (DESIGN.md §10):
    #: a payload round-trip must reproduce every one byte-identically.
    ARRAY_FIELDS = ("src_a", "src_b", "dst", "opcode", "step_opcode",
                    "homogeneous", "input_addrs", "output_addrs",
                    "level_of_step")
    #: scalar/metadata fields riding in the (JSON) manifest side.
    SCALAR_FIELDS = ("n_addr", "trash_addr", "n_inputs", "n_outputs",
                     "n_gates", "depth", "n_unit", "name")

    @property
    def n_steps(self) -> int:
        return int(self.src_a.shape[0])

    # -- persistence payload (core/artifact_store.py) -----------------------

    def to_payload(self) -> tuple[dict, dict]:
        """``(arrays, scalars)`` split of the program: arrays keep their
        exact dtypes (npz side), scalars are JSON-safe (manifest side).
        Exact inverse of :meth:`from_payload`."""
        arrays = {f: getattr(self, f) for f in self.ARRAY_FIELDS}
        scalars = {f: getattr(self, f) for f in self.SCALAR_FIELDS}
        return arrays, scalars

    @classmethod
    def from_payload(cls, arrays: dict, scalars: dict) -> "LogicProgram":
        """Rebuild a program from :meth:`to_payload` output.  Unknown or
        missing fields raise (``KeyError``/``TypeError``) rather than
        defaulting — a persistence layer must never guess at streams."""
        kw = {f: np.asarray(arrays[f]) for f in cls.ARRAY_FIELDS}
        for f in cls.SCALAR_FIELDS:
            v = scalars[f]
            kw[f] = str(v) if f == "name" else int(v)
        extra = (set(arrays) - set(cls.ARRAY_FIELDS)) | \
            (set(scalars) - set(cls.SCALAR_FIELDS))
        if extra:
            raise TypeError(f"unknown LogicProgram payload fields: "
                            f"{sorted(extra)}")
        return cls(**kw)

    @property
    def n_subkernels(self) -> int:
        """Scheduled step count; == eq. 23 with ``fuse_levels=False``,
        <= eq. 23 with fusion enabled."""
        return self.n_steps

    @property
    def step_branch(self) -> np.ndarray:
        """(n_steps,) dispatch-branch index for the banked kernels:
        the opcode itself for homogeneous steps, :data:`MIXED_DISPATCH`
        (generic 8-way select) for mixed tail steps."""
        return np.where(self.homogeneous, self.step_opcode,
                        MIXED_DISPATCH).astype(np.int32)

    def stats(self) -> dict:
        occupancy = self.n_gates / max(1, self.n_steps * self.n_unit)
        return {
            "name": self.name, "n_gates": self.n_gates, "depth": self.depth,
            "n_steps": self.n_steps, "n_unit": self.n_unit,
            "n_addr": self.n_addr, "occupancy": occupancy,
            "homogeneous_frac": float(self.homogeneous.mean())
            if self.n_steps else 1.0,
        }


def _layout_steps_bulk(graph: LogicGraph, lv: Levelization, n_unit: int,
                       ops_col: np.ndarray, opcode_sort: bool):
    """Eq. 23 layout with zero per-level Python work: one global
    (level, opcode) sort + histogram arithmetic. Used whenever fusion is
    off or provably cannot fire (every level fits in one step)."""
    base = graph.first_gate_wire
    hist = lv.histogram()
    steps_per_level = -(-hist // n_unit)
    cum_steps = np.zeros(lv.depth + 1, dtype=np.int64)
    np.cumsum(steps_per_level, out=cum_steps[1:])
    glevels = lv.levels[base:]
    if opcode_sort:
        order = np.lexsort((ops_col, glevels))
    else:
        order = np.argsort(glevels, kind="stable")
    n_steps = int(cum_steps[-1])
    counts = np.full(n_steps, n_unit, dtype=np.int64)
    if n_steps:
        counts[cum_steps[1:] - 1] = hist - (steps_per_level - 1) * n_unit
    level_tag = np.repeat(np.arange(1, lv.depth + 1, dtype=np.int64),
                          steps_per_level)
    return order, counts, level_tag


def _layout_steps(graph: LogicGraph, lv: Levelization, n_unit: int,
                  ops_col: np.ndarray, a_col: np.ndarray, b_col: np.ndarray,
                  unary_mask: np.ndarray, opcode_sort: bool,
                  fuse_levels: bool):
    """Assign every gate to a (step, unit-slot).

    Returns ``(order, counts, level_tag)`` where ``order`` is the gate
    indices in execution order, ``counts[s]`` the number of gates in step
    ``s`` and ``level_tag[s]`` the highest logic level placed in step ``s``.

    Without fusion this is exactly the eq. 23 layout: each level is sliced
    into ``ceil(n_l / n_unit)`` steps (opcode-sorted when requested). With
    fusion, gates may additionally back-fill spare capacity of any earlier
    step whose index is >= 1 + max(def_step of their operands) — safe
    because within a step all reads precede all writes, and a gate is never
    co-scheduled with a producer of one of its operands.
    """
    base = graph.first_gate_wire
    def_step = np.full(graph.n_wires, -1, dtype=np.int64)
    step_chunks: list[list[np.ndarray]] = []   # step -> gate-index arrays
    occ: list[int] = []                        # step -> occupied unit slots
    level_tag: list[int] = []

    for level in range(1, lv.depth + 1):
        gates = lv.gates_at(level)
        ops_l = ops_col[gates]
        placed = 0
        if fuse_levels:
            ma = def_step[a_col[gates]]
            mb = np.where(unary_mask[gates], np.int64(-1),
                          def_step[b_col[gates]])
            min_step = np.maximum(ma, mb) + 1      # earliest legal step
            keys = (ops_l, min_step) if opcode_sort else (min_step,)
            order_l = np.lexsort(keys)
            gs, ms = gates[order_l], min_step[order_l]
            # back-fill spare capacity of existing steps, earliest first
            s = int(ms[0]) if len(gs) else 0
            while placed < len(gs) and s < len(step_chunks):
                cap = n_unit - occ[s]
                if cap > 0:
                    eligible = int(np.searchsorted(ms, s, side="right"))
                    k = min(cap, eligible - placed)
                    if k > 0:
                        take = gs[placed:placed + k]
                        step_chunks[s].append(take)
                        occ[s] += k
                        def_step[base + take] = s
                        level_tag[s] = level
                        placed += k
                s += 1
            rem = gs[placed:]
            if opcode_sort and len(rem):
                rem = rem[np.argsort(ops_col[rem], kind="stable")]
        elif opcode_sort:
            rem = gates[np.argsort(ops_l, kind="stable")]
        else:
            rem = gates
        # leftover gates open fresh steps at the end (all operands are in
        # earlier steps by construction, so any packing is legal)
        for off in range(0, len(rem), n_unit):
            chunk = rem[off:off + n_unit]
            def_step[base + chunk] = len(step_chunks)
            step_chunks.append([chunk])
            occ.append(len(chunk))
            level_tag.append(level)

    if step_chunks:
        order = np.concatenate(
            [c[0] if len(c) == 1 else np.concatenate(c)
             for c in step_chunks])
    else:
        order = np.zeros(0, dtype=np.int64)
    counts = np.asarray(occ, dtype=np.int64)
    return order, counts, np.asarray(level_tag, dtype=np.int64)


def compile_graph(graph: LogicGraph, spec: CompileSpec | int | None = None,
                  lv: Levelization | None = None, *,
                  n_unit=_UNSET, alloc=_UNSET, opcode_sort=_UNSET,
                  fuse_levels=_UNSET, optimize=_UNSET) -> LogicProgram:
    """Schedule ``graph`` onto the fabric described by ``spec``.

    ``spec`` is the one declarative compilation target
    (:class:`~repro.core.spec.CompileSpec`; canonical defaults when
    omitted).  The scheduling knobs it carries:

      * ``spec.opcode_sort`` groups each level's gates by opcode so
        steps are opcode-homogeneous (one slab op in the kernels);
      * ``spec.fuse_levels`` lets gates back-fill spare unit slots of
        earlier steps, shrinking ``n_steps`` below the eq. 23 count
        (DESIGN.md §1) — ``CompileSpec.paper_exact()`` turns both off;
      * ``spec.optimize`` runs the gate-level pass pipeline
        (core/opt.py) before levelization.  The program's I/O interface
        is unchanged — passes never touch primary inputs or output
        ordering — but ``n_gates``/``n_steps``/``depth`` reflect the
        optimized graph.

    This is the *monolithic* primitive: ``spec.max_gates`` is ignored
    here (budget-aware compilation — partitioning plus the output
    permutation — lives in :class:`~repro.core.compiler.LogicCompiler`),
    and ``spec.n_unit`` must be concrete (``"auto"`` resolution needs
    the facade's cost-model context).

    The loose ``n_unit``/``alloc``/``opcode_sort``/``fuse_levels``/
    ``optimize`` kwargs (and a bare int ``spec``) are the deprecated
    pre-spec convention — they still work, with a ``DeprecationWarning``
    and the canonical defaults for anything unspecified.
    """
    spec = resolve_spec(spec, caller="compile_graph", n_unit=n_unit,
                        alloc=alloc, opcode_sort=opcode_sort,
                        fuse_levels=fuse_levels, optimize=optimize)
    if lv is not None and not isinstance(lv, Levelization):
        # the pre-spec signature took alloc as the 3rd positional; a stale
        # compile_graph(g, 16, "direct") call would otherwise silently
        # bind the string to lv and compile with the wrong allocator
        raise TypeError(
            f"compile_graph's third parameter is a Levelization, got "
            f"{lv!r}; the old positional alloc argument moved onto the "
            f"spec — pass CompileSpec(alloc=...)")
    if not spec.resolved:
        raise ValueError(
            "compile_graph needs a concrete n_unit; resolve "
            "n_unit='auto' through LogicCompiler (core/compiler.py) or "
            "the serving registry first")
    n_unit, alloc = spec.n_unit, spec.alloc
    opcode_sort, fuse_levels = spec.opcode_sort, spec.fuse_levels
    pipeline = spec.pipeline
    if pipeline is not None:
        graph = pipeline.run(graph).graph
        lv = None                      # levelization refers to the old graph
    lv = lv or levelize(graph)
    base = graph.first_gate_wire

    if graph.n_gates:
        # ~5x faster than np.asarray on a large list of tuples
        gates_arr = np.fromiter(
            itertools.chain.from_iterable(graph.gates), dtype=np.int64,
            count=3 * graph.n_gates).reshape(graph.n_gates, 3)
    else:
        gates_arr = np.zeros((0, 3), dtype=np.int64)
    ops_col, a_col, b_col = gates_arr[:, 0], gates_arr[:, 1], gates_arr[:, 2]
    unary_mask = (ops_col == int(OpCode.NOT)) | (ops_col == int(OpCode.COPY))

    # --- step layout (levelize -> opcode-sort -> fuse) ---
    # Back-fill fusion can only fire when some level spans >= 2 steps (a
    # single-step level pins every next-level gate's earliest step past
    # it); otherwise the fully-bulk eq. 23 layout is equivalent and avoids
    # the per-level scheduling loop entirely.
    if not fuse_levels or not graph.n_gates or \
            int(lv.histogram().max()) <= n_unit:
        order, counts, level_tag = _layout_steps_bulk(
            graph, lv, n_unit, ops_col, opcode_sort)
    else:
        order, counts, level_tag = _layout_steps(
            graph, lv, n_unit, ops_col, a_col, b_col, unary_mask,
            opcode_sort, fuse_levels)
    n_steps = len(counts)
    starts = np.zeros(n_steps + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    step_idx = np.repeat(np.arange(n_steps, dtype=np.int64), counts)
    pos = np.arange(len(order), dtype=np.int64) - np.repeat(
        starts[:-1], counts)

    # --- step index at which each wire is last read (bulk, no gate loop) ---
    last_read = np.full(graph.n_wires, -1, dtype=np.int64)
    if len(order):
        np.maximum.at(last_read, a_col[order], step_idx)
        binary = ~unary_mask[order]
        np.maximum.at(last_read, b_col[order][binary], step_idx[binary])
    if graph.outputs:
        last_read[np.asarray(graph.outputs, dtype=np.int64)] = n_steps

    # --- address allocation ---
    addr = np.full(graph.n_wires, -1, dtype=np.int64)
    if alloc == "direct":
        addr[:] = np.arange(graph.n_wires)
        trash = graph.n_wires
        n_addr = graph.n_wires + 1
    else:
        addr[CONST0], addr[CONST1] = 0, 1
        addr[2:base] = np.arange(2, base)
        next_fresh = base
        free: list[int] = []
        # release queue: step -> addresses that become free at that step
        release: list[list[int]] = [[] for _ in range(n_steps + 1)]
        pre_lr = last_read[:base]
        for w in np.nonzero((pre_lr >= 0) & (pre_lr < n_steps))[0]:
            release[pre_lr[w] + 1].append(int(addr[w]))
        gate_lr = last_read[base + order].tolist()
        starts_l, assigned = starts.tolist(), []
        for si in range(n_steps):
            if release[si]:
                free.extend(release[si])
            for j in range(starts_l[si], starts_l[si + 1]):
                if free:
                    a = free.pop()
                else:
                    a = next_fresh
                    next_fresh += 1
                assigned.append(a)
                lr = gate_lr[j]
                if 0 <= lr < n_steps:
                    release[lr + 1].append(a)
                elif lr == -1:  # dead gate: reusable immediately next step
                    release[si + 1].append(a)
        if len(order):
            addr[base + order] = np.asarray(assigned, dtype=np.int64)
        trash = next_fresh
        n_addr = next_fresh + 1

    # --- emit streams (bulk scatter, no per-gate/per-unit loop) ---
    src_a = np.zeros((n_steps, n_unit), dtype=np.int32)
    src_b = np.zeros((n_steps, n_unit), dtype=np.int32)
    dst = np.full((n_steps, n_unit), trash, dtype=np.int32)
    opcode = np.zeros((n_steps, n_unit), dtype=np.int32)  # NOP
    if len(order):
        src_a[step_idx, pos] = addr[a_col[order]]
        b_read = np.where(unary_mask[order], np.int64(CONST0), b_col[order])
        src_b[step_idx, pos] = addr[b_read]
        dst[step_idx, pos] = addr[base + order]
        opcode[step_idx, pos] = ops_col[order]

    # --- per-step homogeneity metadata ---
    if n_steps:
        mx = opcode.max(axis=1)
        mn = np.where(opcode == 0, np.int32(127), opcode).min(axis=1)
        # A step is homogeneous only if its opcode-0 lanes are pure padding
        # (dst == trash): a *real* NOP gate must produce 0 on its wire, which
        # the specialized non-NOP slab op would clobber. All-NOP steps are
        # safe either way (the NOP branch writes the correct 0).
        pad_only = ((opcode != 0) | (dst == trash)).all(axis=1)
        homogeneous = (mx == 0) | ((mx == mn) & pad_only)
        step_opcode = np.where(homogeneous, mx, 0).astype(np.int32)
    else:
        homogeneous = np.zeros(0, dtype=bool)
        step_opcode = np.zeros(0, dtype=np.int32)

    return LogicProgram(
        src_a=src_a, src_b=src_b, dst=dst, opcode=opcode,
        step_opcode=step_opcode, homogeneous=homogeneous,
        n_addr=int(n_addr), trash_addr=int(trash),
        input_addrs=addr[2:2 + graph.n_inputs].astype(np.int64),
        output_addrs=addr[np.asarray(graph.outputs, dtype=np.int64)].astype(
            np.int64) if graph.outputs else np.zeros(0, np.int64),
        n_inputs=graph.n_inputs, n_outputs=graph.n_outputs,
        n_gates=graph.n_gates, depth=lv.depth,
        level_of_step=level_tag,
        n_unit=n_unit, name=graph.name,
    )


@dataclass(frozen=True)
class MegaProgram:
    """A whole program *pipeline* flattened for single-launch execution.

    The per-stage :class:`LogicProgram` streams are concatenated along the
    step axis (lanes padded to the widest stage's ``n_unit`` with NOPs
    writing that stage's own trash row), with a static per-stage offset
    table (``stage_meta``) into the shared scratch buffer sized by the
    *maximum* ``n_addr`` across stages.  The megakernel
    (kernels/logic_dsp/kernel.py) walks the table inside ONE
    ``pallas_call``:

      * ``mode="chain"``    — stage *k*'s output-addrs gather feeds stage
        *k+1*'s input slice without leaving the kernel (the classifier's
        per-layer launch chain fused; paper §5.2's cascaded DSP stages);
      * ``mode="parallel"`` — every stage reads the same primary-input
        slab (a partitioned pipeline); the per-stage output slabs are
        concatenated and permuted back to the original output order by
        ``output_perm`` in-kernel.

    Each stage re-initializes the buffer (zeros, const-1 row, inputs at
    rows 2..) because the liveness allocator may have released const or
    input rows for reuse as gate destinations — stale rows from stage
    *k* must never be observable to stage *k+1*'s address space.
    """

    mode: str                        # "chain" | "parallel"
    stages: tuple                    # the source LogicPrograms, in order
    # concatenated streams, (total_steps, n_unit) int32
    src_a: np.ndarray
    src_b: np.ndarray
    dst: np.ndarray
    opcode: np.ndarray
    step_branch: np.ndarray          # (total_steps,) int32 dispatch branch
    step_trash: np.ndarray           # (total_steps,) int32 owning stage's
    #                                  trash row (lane-padding fill value)
    out_addrs: np.ndarray            # (sum stage n_outputs,) int64
    output_perm: np.ndarray          # (n_outputs,) int64; identity for chain
    #: static per-stage offset table — one (step_lo, step_hi, n_inputs,
    #: n_outputs, out_lo) tuple per stage; hashable, closed over by the
    #: kernel as trace-time constants.
    stage_meta: tuple
    n_addr: int                      # max over stages (scratch sizing rule)
    n_unit: int                      # max over stages (lane-padded width)
    n_inputs: int
    n_outputs: int
    name: str = "mega"

    @property
    def total_steps(self) -> int:
        return int(self.src_a.shape[0])

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def build_megaprogram(programs, mode: str = "chain",
                      output_perm: np.ndarray | None = None,
                      name: str | None = None) -> MegaProgram:
    """Flatten a program pipeline into one :class:`MegaProgram`.

    ``mode="chain"`` requires ``programs[k].n_outputs ==
    programs[k+1].n_inputs`` (the packed-handoff width contract);
    ``mode="parallel"`` requires every stage to share the primary-input
    width and takes the partition ``output_perm`` (identity = plain
    concatenation order).
    """
    programs = tuple(programs)
    if not programs:
        raise ValueError("build_megaprogram needs at least one stage")
    if mode not in ("chain", "parallel"):
        raise ValueError(f"unknown mega mode {mode!r}")
    if mode == "chain":
        if output_perm is not None:
            raise ValueError("chain mode has no output permutation: the "
                             "last stage's outputs ARE the pipeline's")
        for k in range(len(programs) - 1):
            if programs[k].n_outputs != programs[k + 1].n_inputs:
                raise ValueError(
                    f"stage width mismatch: stage {k} produces "
                    f"{programs[k].n_outputs} outputs, stage {k + 1} "
                    f"expects {programs[k + 1].n_inputs} inputs")
        n_inputs = programs[0].n_inputs
        n_outputs = programs[-1].n_outputs
        perm = np.arange(n_outputs, dtype=np.int64)
    else:
        n_inputs = programs[0].n_inputs
        for p in programs[1:]:
            if p.n_inputs != n_inputs:
                raise ValueError(
                    "parallel stages must share the primary-input width")
        n_outputs = sum(p.n_outputs for p in programs)
        perm = (np.arange(n_outputs, dtype=np.int64) if output_perm is None
                else np.asarray(output_perm, dtype=np.int64))
        if perm.shape != (n_outputs,) or \
                not np.array_equal(np.sort(perm), np.arange(n_outputs)):
            raise ValueError("output_perm must be a permutation of "
                             f"range({n_outputs})")
    n_unit = max(p.n_unit for p in programs)
    n_addr = max(p.n_addr for p in programs)

    # Trash-row isolation (DESIGN.md §13): every padding lane and
    # step_trash entry below points at the owning stage's trash row,
    # and the megakernel re-initializes rows 0..1+n_inputs (consts +
    # input slice) at every stage boundary.  A trash row aliasing one
    # of those preload rows would let NOP padding clobber a live
    # const/input mid-stage.  Both allocators only ever hand out fresh
    # rows past the preload region, so a violation here means the
    # program came from an untrusted payload (LogicProgram.from_payload
    # does not validate semantics) — refuse loudly rather than fuse a
    # schedule the static verifier would reject.
    for k, p in enumerate(programs):
        if not (2 + p.n_inputs <= p.trash_addr < p.n_addr):
            raise ValueError(
                f"stage {k} ({p.name!r}): trash_addr {p.trash_addr} "
                f"aliases a const/input row (or exceeds n_addr "
                f"{p.n_addr}); refusing to build a megaprogram whose "
                "padding lanes would clobber live preload rows")

    streams = {"src_a": [], "src_b": [], "dst": [], "opcode": []}
    branch, trash, out_addrs, meta = [], [], [], []
    step_lo = out_lo = 0
    for p in programs:
        pad = n_unit - p.n_unit

        def padded(a, fill):
            a = np.asarray(a, dtype=np.int32)
            if pad:
                a = np.pad(a, ((0, 0), (0, pad)), constant_values=fill)
            return a

        streams["src_a"].append(padded(p.src_a, 0))
        streams["src_b"].append(padded(p.src_b, 0))
        streams["dst"].append(padded(p.dst, p.trash_addr))
        streams["opcode"].append(padded(p.opcode, 0))
        branch.append(p.step_branch)
        trash.append(np.full(p.n_steps, p.trash_addr, dtype=np.int32))
        out_addrs.append(np.asarray(p.output_addrs, dtype=np.int64))
        meta.append((step_lo, step_lo + p.n_steps,
                     p.n_inputs, p.n_outputs, out_lo))
        step_lo += p.n_steps
        out_lo += p.n_outputs

    def cat(chunks, width=None):
        if width is None:
            return np.concatenate(chunks) if chunks else \
                np.zeros(0, dtype=np.int32)
        return np.concatenate(chunks, axis=0) if chunks else \
            np.zeros((0, width), dtype=np.int32)

    return MegaProgram(
        mode=mode, stages=programs,
        src_a=cat(streams["src_a"], n_unit),
        src_b=cat(streams["src_b"], n_unit),
        dst=cat(streams["dst"], n_unit),
        opcode=cat(streams["opcode"], n_unit),
        step_branch=cat(branch).astype(np.int32),
        step_trash=cat(trash).astype(np.int32),
        out_addrs=cat(out_addrs).astype(np.int64),
        output_perm=perm, stage_meta=tuple(meta),
        n_addr=int(n_addr), n_unit=int(n_unit),
        n_inputs=int(n_inputs), n_outputs=int(n_outputs),
        name=name or "+".join(p.name for p in programs))


def execute_megaprogram_np(mega: MegaProgram, inputs: np.ndarray
                           ) -> np.ndarray:
    """Numpy oracle for mega execution — the chained / re-assembled
    :func:`execute_program_np` the fused kernel must match bit-for-bit."""
    inputs = np.asarray(inputs)
    if mega.mode == "chain":
        h = inputs
        for p in mega.stages:
            h = execute_program_np(p, h)
        return h
    outs = [execute_program_np(p, inputs) for p in mega.stages]
    cat = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)
    return cat[:, mega.output_perm]


def execute_program_np(prog: LogicProgram, inputs: np.ndarray) -> np.ndarray:
    """Numpy oracle for program execution on a boolean batch.

    This is the semantic contract the Pallas kernel (kernels/logic_dsp) and
    the jnp reference (kernels/logic_dsp/ref.py) are tested against, and it
    itself is tested against direct ``LogicGraph.evaluate``. Homogeneous
    steps apply one bulk op to the whole (n_unit, W) slab; only mixed tail
    steps fall back to per-opcode masking (never a per-unit Python loop).

    While a :class:`~repro.core.calibrate.PhaseTimer` is active, the run
    records its pack / setup (buffer init + input scatter) / kernel
    (step loop) / unpack split on the timer (``backend="numpy"``) — the
    same phase shape the jitted path reports, so the calibration
    tooling can compare backends.  Disabled, the check is one module
    attribute read.
    """
    timer = _calibrate._ACTIVE
    t = time.perf_counter
    t0 = t()
    inputs = np.asarray(inputs)
    batch = inputs.shape[0]
    words = packing.pack_bits(inputs.astype(np.uint8))       # (n_inputs, W)
    t1 = t()
    w = words.shape[1]
    buf = np.zeros((prog.n_addr, w), dtype=np.int32)
    buf[1] = -1  # const-1 row = all ones
    buf[prog.input_addrs] = words
    branch = prog.step_branch
    t2 = t()
    for s in range(prog.n_steps):
        a = buf[prog.src_a[s]]
        b = buf[prog.src_b[s]]
        br = int(branch[s])
        if br < MIXED_DISPATCH:                  # homogeneous: one slab op
            res = apply_op(br, a, b)
        else:                                    # mixed tail step
            ops_row = prog.opcode[s]
            res = np.zeros_like(a)
            for oc in np.unique(ops_row):
                lanes = ops_row == oc
                res[lanes] = apply_op(int(oc), a[lanes], b[lanes])
        buf[prog.dst[s]] = res
    t3 = t()
    out_words = buf[prog.output_addrs]
    out = packing.unpack_bits(out_words, batch)
    if timer is not None:
        timer.record({"pack": t1 - t0, "setup": t2 - t1, "kernel": t3 - t2,
                      "unpack": t() - t3},
                     backend="numpy", n_unit=prog.n_unit, batch=batch)
    return out
