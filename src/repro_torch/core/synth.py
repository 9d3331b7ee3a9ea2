# Copied from src/repro/core/synth.py; only the repro imports differ.
"""Logic synthesis passes (ABC stand-in, paper §6.1) — legacy facade.

The paper runs ``resyn; resyn2; resyn2rs; compress2rs; st; map; dch; map``
in ABC with two objectives: minimize total gate count and maximum logic
depth (both appear directly in the cycle-count model, eq. 23). ABC is
unavailable offline; the rewrites live in **core/opt.py** as composable
passes with wire remaps (DESIGN.md §7):

  * constant folding        (:class:`~repro.core.opt.ConstantFold`)
  * structural hashing/CSE  (:class:`~repro.core.opt.StructuralHash`)
  * algebraic identities    (:class:`~repro.core.opt.SimplifyIdentities`:
                             double-NOT, idempotence, NOT-fusion into
                             NAND/NOR/XNOR — "technology mapping" onto
                             the full DSP opcode set)
  * dead-gate elimination   (:class:`~repro.core.opt.DeadGateElim`)
  * associative rebalancing (:class:`~repro.core.opt.Rebalance`)

This module keeps the original graph-in/graph-out names for callers that
don't need remaps; new code should use :class:`repro.core.opt.PassManager`
directly (or the ``optimize=`` knob on ``scheduler.compile_graph`` /
``nullanet.layer_to_graph`` / the flow and serving layers).

``optimize(graph)`` runs the default pipeline to a fixed point and is
semantics-preserving: tests assert ``evaluate`` equality on random
vectors and via hypothesis.
"""
from __future__ import annotations

from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.opt import (DeadGateElim, PassManager,
                            Rebalance as _Rebalance)


def dead_gate_elim(graph: LogicGraph) -> LogicGraph:
    """Remove gates not reachable (backwards) from any output."""
    return DeadGateElim().run(graph).graph


def rebalance(graph: LogicGraph) -> LogicGraph:
    """Rebuild associative same-op chains as balanced trees (depth cut).

    A chain ``(((a&b)&c)&d)`` has depth 3; the balanced tree has depth 2.
    Only single-fanout internal nodes are absorbed, so gate count never
    grows.
    """
    return _Rebalance().run(graph).graph


def optimize(graph: LogicGraph, max_iters: int = 8) -> LogicGraph:
    """Run the default pass pipeline to a fixed point on (n_gates, depth)."""
    return PassManager.default(max_iters=max_iters).run(graph).graph
