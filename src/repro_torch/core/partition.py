# Copied from src/repro/core/partition.py; only the repro imports differ.
"""FFCL graph partitioning: split modules that exceed the on-chip budget.

The paper's §2 closes with: "by leveraging a hybrid implementation, i.e.,
mapping some FFCL modules to LUTs and others to DSPs, a high-performance
inference engine for ANY network on ANY FPGA device can be achieved." The
TPU analogue of the resource wall is the VMEM data buffer: a compiled
program needs `n_addr x W x 4` bytes resident; graphs from wide NullaNet
layers can exceed the per-core budget.

``partition(graph, max_outputs | budget)`` splits a multi-output FFCL into
sub-FFCLs by *output-cone clustering*: each output's transitive fanin cone
is computed, and outputs are greedily packed into clusters that maximize
cone overlap (shared gates are deduplicated inside a cluster but duplicated
across clusters — the classic area/latency trade the paper's LUT/DSP hybrid
makes). The resulting modules execute back-to-back on the same fabric with
task pipelining (simulator.py), exactly like the paper's multi-FFCL flow.

``execute_partitions`` re-assembles the full output vector and is tested
for exact equivalence against the unpartitioned graph. The serving engine
(serve/logic_engine.py) does the same re-assembly at the packed-word level:
``output_permutation`` maps the concatenation of per-partition output rows
back to the original output order, so a partitioned graph is served as a
pipelined sequence of programs over ONE packed input slab.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.gate_ir import CONST0, CONST1, LogicGraph, OpCode, UNARY
from repro_torch.core.opt import resolve_pipeline
from repro_torch.core.scheduler import LogicProgram, compile_graph
from repro_torch.core.spec import CompileSpec, resolve_spec, _UNSET
from repro_torch.core.verify import (ScheduleVerificationError, VerifyReport,
                               certify_remap)


def output_cones(graph: LogicGraph) -> list[set]:
    """Transitive-fanin gate set (wire ids) per output."""
    memo: dict[int, frozenset] = {}

    def cone(w: int) -> frozenset:
        if w in memo:
            return memo[w]
        if not graph.is_gate(w):
            memo[w] = frozenset()
            return memo[w]
        op, a, b = graph.gate_of_wire(w)
        s = {w} | set(cone(a))
        if OpCode(op) not in UNARY:
            s |= set(cone(b))
        memo[w] = frozenset(s)
        return memo[w]

    # iterative bottom-up to avoid recursion limits on deep graphs
    base = graph.first_gate_wire
    for i in range(graph.n_gates):
        w = base + i
        op, a, b = graph.gates[i]
        s = {w} | set(memo.get(a, frozenset()))
        if OpCode(op) not in UNARY:
            s |= set(memo.get(b, frozenset()))
        memo[w] = frozenset(s)
    return [set(memo.get(o, frozenset())) for o in graph.outputs]


@dataclass(frozen=True)
class Partition:
    graph: LogicGraph           # sub-FFCL (inputs = original inputs)
    output_indices: list        # positions in the original output vector


def _extract(graph: LogicGraph, out_idx: list[int]) -> LogicGraph:
    """Sub-graph computing the given outputs (gates outside the union of
    their cones dropped, topological order preserved)."""
    keep_outputs = [graph.outputs[i] for i in out_idx]
    live = set(keep_outputs)
    base = graph.first_gate_wire
    for i in range(graph.n_gates - 1, -1, -1):
        w = base + i
        if w in live:
            op, a, b = graph.gates[i]
            live.add(a)
            if OpCode(op) not in UNARY:
                live.add(b)
    sub = LogicGraph(graph.n_inputs, name=f"{graph.name}.part")
    repl = {CONST0: CONST0, CONST1: CONST1}
    for i in range(graph.n_inputs):
        repl[2 + i] = 2 + i
    for i in range(graph.n_gates):
        w = base + i
        if w in live:
            op, a, b = graph.gates[i]
            repl[w] = sub.add_gate(OpCode(op), repl[a], repl.get(b, CONST0))
    sub.set_outputs(repl[o] for o in keep_outputs)
    return sub


def partition(graph: LogicGraph, max_gates: int | CompileSpec, *,
              optimize=_UNSET) -> list[Partition]:
    """Greedy cone-overlap clustering under a per-partition gate budget.

    Each cluster's gate set is the union of its members' cones; a new
    output joins the cluster where it adds the fewest NEW gates, if the
    union stays <= max_gates; otherwise it seeds a new cluster.

    ``max_gates`` is either the bare budget (an int — partitioning's
    core argument, not deprecated) or a full
    :class:`~repro.core.spec.CompileSpec`, whose ``max_gates`` must be
    set and whose ``optimize`` pipeline runs on each extracted cluster
    cone: cross-cluster gate duplication re-exposes
    constant/CSE/dead-fanin slack *inside* a cluster that global
    optimization could not see, so per-cluster passes shrink the
    per-program buffer budget the partitioning exists to bound. Budget
    accounting stays on the raw cone sizes (optimization only shrinks a
    cluster, never grows it).

    The loose ``optimize=`` kwarg is the deprecated pre-spec
    convention (``DeprecationWarning``); pass a spec instead.
    """
    if isinstance(max_gates, CompileSpec):
        if optimize is not _UNSET:
            raise TypeError("partition: pass either a CompileSpec or the "
                            "legacy optimize= kwarg, not both")
        spec = max_gates
        if spec.max_gates is None:
            raise ValueError(
                "partition needs a budget: spec.max_gates must be set")
        max_gates, pipeline = spec.max_gates, spec.pipeline
        certify = spec.verify in ("compile", "full")
    else:
        certify = False
        import warnings
        from repro_torch.core.spec import DEPRECATION_PREFIX
        if optimize is _UNSET:
            pipeline = None
        else:
            warnings.warn(
                f"{DEPRECATION_PREFIX}: partition(optimize=...) is "
                "deprecated; pass a CompileSpec as the budget argument",
                DeprecationWarning, stacklevel=2)
            pipeline = resolve_pipeline(optimize)
    if graph.n_outputs == 0:
        return []
    cones = output_cones(graph)
    order = np.argsort([-len(c) for c in cones], kind="stable")
    clusters: list[tuple[set, list]] = []   # (gate union, output indices)
    for oi in order:
        oi = int(oi)
        cone = cones[oi]
        best, best_new = None, None
        for ci, (union, members) in enumerate(clusters):
            new = len(cone - union)
            if len(union) + new <= max_gates and \
                    (best_new is None or new < best_new):
                best, best_new = ci, new
        if best is None:
            clusters.append((set(cone), [oi]))
        else:
            clusters[best][0].update(cone)
            clusters[best][1].append(oi)
    parts = []
    for _, members in clusters:
        sub = _extract(graph, members)
        if pipeline is not None:
            res = pipeline.run(sub)
            if certify:
                # per-cluster remap certificate (verify="compile"/"full",
                # DESIGN.md §13): the rewrite must map the cone's outputs
                # totally and in range before its program is trusted
                diags = certify_remap(sub, res.graph, res.remap,
                                      label=f"partition({sub.name})")
                if diags:
                    raise ScheduleVerificationError(VerifyReport(
                        target=sub.name, diagnostics=tuple(diags)))
            sub = res.graph
        parts.append(Partition(graph=sub, output_indices=members))
    return parts


def compile_partitions(parts: list[Partition],
                       spec: CompileSpec | int | None = None, *,
                       n_unit=_UNSET, alloc=_UNSET) -> list[LogicProgram]:
    """Schedule every sub-FFCL per ``spec``'s fabric/layout knobs.

    The optimize stage is stripped (``optimize="none"``): ``partition``
    already ran the pipeline per cluster, so re-running it here would be
    pure waste — and the pre-spec behaviour compiled parts raw, which
    this preserves exactly.  ``max_gates`` is likewise moot (the parts
    ARE the budget's product).  Legacy ``n_unit``/``alloc`` kwargs warn.
    """
    spec = resolve_spec(spec, caller="compile_partitions",
                        n_unit=n_unit, alloc=alloc)
    mono = spec.with_(optimize="none", max_gates=None)
    return [compile_graph(p.graph, mono) for p in parts]


def output_permutation(parts: list[Partition], n_outputs: int) -> np.ndarray:
    """Permutation ``perm`` with ``concat(part outputs)[perm] == original``.

    Row ``perm[oi]`` is the position of original output ``oi`` in the
    concatenation of the partitions' output vectors (in partition order).
    Every partition shares the full primary-input vector, so stacking the
    per-program ``(n_out_p, W)`` output slabs and gathering with ``perm``
    re-assembles the monolithic ``(n_outputs, W)`` result without
    unpacking — the word-level analogue of :func:`execute_partitions`.
    """
    perm = np.full(n_outputs, -1, dtype=np.int64)
    pos = 0
    for p in parts:
        for oi in p.output_indices:
            perm[oi] = pos
            pos += 1
    if pos != n_outputs or (perm < 0).any():
        raise ValueError("partitions do not cover every output exactly once")
    return perm


def mega_pipeline(programs, output_perm: np.ndarray,
                  mode: str = "parallel", name: str = "pipeline"):
    """Flatten a compiled pipeline into one single-launch
    :class:`~repro.core.scheduler.MegaProgram`.

    For ``mode="parallel"`` (a partitioned artifact) the partitions'
    concatenated output slabs are permuted back to the original output
    order *inside* the kernel — the word-level re-assembly
    :func:`output_permutation` describes stops being a separate host/XLA
    gather step and the whole pipeline becomes one ``pallas_call``.  For
    ``mode="chain"`` the permutation is necessarily identity (the last
    stage's outputs are the pipeline's) and stage handoff fuses instead.
    """
    from repro_torch.core.scheduler import build_megaprogram
    if mode == "chain":
        return build_megaprogram(programs, mode="chain", name=name)
    return build_megaprogram(programs, mode="parallel",
                             output_perm=output_perm, name=name)


def execute_partitions(parts: list[Partition], inputs: np.ndarray,
                       executor=None) -> np.ndarray:
    """Run every sub-FFCL and reassemble the original output order."""
    n_out = sum(len(p.output_indices) for p in parts)
    out = np.zeros((inputs.shape[0], n_out), dtype=bool)
    for p in parts:
        run = executor or (lambda g, x: g.evaluate(x))
        sub_out = run(p.graph, inputs)
        for j, oi in enumerate(p.output_indices):
            out[:, oi] = sub_out[:, j]
    return out


def duplication_factor(graph: LogicGraph, parts: list[Partition]) -> float:
    """Total gates across partitions / original gates (the area cost of
    the split; the latency gain comes from pipelining + smaller buffers)."""
    if graph.n_gates == 0:
        return 1.0
    return sum(p.graph.n_gates for p in parts) / graph.n_gates
