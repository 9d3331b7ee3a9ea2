# Copied from src/repro/core/espresso.py; only the repro imports differ.
"""Two-level logic minimization over incompletely specified functions.

Place in the synthesis flow: this is the *first* synthesis stage, where a
neuron's truth-table semantics become Boolean structure. NullaNet (paper
§7.1, core/nullanet.py) forms each neuron's spec either by full input
enumeration (small fanin) or as an ISF sampled from training data: an
on-set, an off-set, and everything unobserved as don't-care. ``minimize``
compresses that spec into a small sum-of-products cover; ``sop_to_graph``
factors the cover into the 2-input gate DAG that multi-level restructuring
(core/synth.py), the scheduler (core/scheduler.py), and ultimately the
serving engine consume. The ISF don't-care set is where the paper's
accuracy/area trade lives — the fewer observed minterms, the more freedom
EXPAND has.

This module implements an espresso-style EXPAND / IRREDUNDANT loop over
cube lists:

  cube = (mask, val): covers x  iff  all(x[mask] == val[mask]).

EXPAND greedily drops literals from each on-cube while it stays disjoint
from the off-set (don't-cares absorb automatically: anything not in the
off-set may be covered). IRREDUNDANT removes cubes whose on-set coverage is
contained in the union of the others. The result is a minimal-ish SOP that
``sop_to_graph`` factors into a 2-input gate DAG for the FFCL compiler.

>>> import numpy as np
>>> X_on = np.array([[0, 0], [0, 1]], dtype=np.uint8)   # f = ~a (b free)
>>> X_off = np.array([[1, 0], [1, 1]], dtype=np.uint8)
>>> cubes = minimize(X_on, X_off)
>>> len(cubes)                         # one cube: a == 0, b dropped
1
>>> int(cubes[0][0].sum())             # a single literal survives
1
>>> check_cover(cubes, X_on, X_off)
True
>>> g = sop_to_graph([cubes], n_inputs=2)
>>> bool(g.evaluate(np.array([[0, 1]], dtype=bool))[0, 0])
True
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.gate_ir import CONST0, CONST1, LogicGraph, OpCode


def _covers(mask: np.ndarray, val: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Which rows of X (n, v) the cube covers -> bool (n,)."""
    if X.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    return ((X == val) | ~mask).all(axis=1)


def expand_cube(mask: np.ndarray, val: np.ndarray, X_off: np.ndarray,
                order: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop literals (in ``order``) while the cube avoids the off-set.

    Incremental formulation: track, per off-minterm, how many masked
    literals it mismatches. Dropping literal i covers an off-minterm iff
    that minterm's ONLY mismatch is at i, so a drop is safe iff no row has
    (count == 1 and mismatch at i); a safe drop just subtracts its column
    from the counts. O(v * |off|) total vs O(v^2 * |off|) for the naive
    re-check — the difference between minutes and milliseconds at VGG16
    fanins (2304-4608 literals)."""
    mask = mask.copy()
    if X_off.shape[0] == 0:
        mask[:] = False            # no off-set: the cube expands to 1
        return mask, val
    mismatch = (X_off != val) & mask          # (n_off, v)
    counts = mismatch.sum(axis=1)             # per off-minterm
    for i in order:
        if not mask[i]:
            continue
        col = mismatch[:, i]
        if np.any(col & (counts == 1)):
            continue                           # would cover an off-minterm
        mask[i] = False
        counts = counts - col
        mismatch[:, i] = False
    return mask, val


def minimize(X_on: np.ndarray, X_off: np.ndarray,
             rng: np.random.Generator | None = None,
             max_literal_tries: int | None = None
             ) -> list[tuple[np.ndarray, np.ndarray]]:
    """ISF two-level minimization.

    Args:
      X_on / X_off: uint8/bool arrays (n_on, v), (n_off, v) of minterms.
    Returns:
      list of cubes (mask, val) covering every on-minterm, disjoint from
      every off-minterm.
    """
    X_on = np.asarray(X_on, dtype=np.uint8)
    X_off = np.asarray(X_off, dtype=np.uint8)
    if X_on.ndim != 2:
        raise ValueError("X_on must be 2-D")
    n_on, v = X_on.shape
    if n_on == 0:
        return []
    rng = rng or np.random.default_rng(0)

    # literal drop order: try most "balanced" variables first (likely
    # droppable); stable heuristic = ascending |bias| on the on-set.
    bias = np.abs(X_on.mean(axis=0) - 0.5)
    base_order = np.argsort(bias, kind="stable")

    cubes: list[tuple[np.ndarray, np.ndarray]] = []
    covered = np.zeros(n_on, dtype=bool)
    full_mask = np.ones(v, dtype=bool)
    while not covered.all():
        seed_idx = int(np.flatnonzero(~covered)[0])
        val = X_on[seed_idx].copy()
        mask, val = expand_cube(full_mask.copy(), val, X_off, base_order)
        newly = _covers(mask, val, X_on)
        covered |= newly
        cubes.append((mask, val))

    # IRREDUNDANT: greedily drop cubes whose coverage is subsumed.
    cover = np.stack([_covers(m, c, X_on) for m, c in cubes], axis=0)
    keep = np.ones(len(cubes), dtype=bool)
    sizes = cover.sum(axis=1)
    for i in np.argsort(sizes, kind="stable"):       # smallest first
        keep[i] = False
        if not cover[keep].any(axis=0).all():
            keep[i] = True
    return [c for k, c in zip(keep, cubes) if k]


def check_cover(cubes, X_on: np.ndarray, X_off: np.ndarray) -> bool:
    """Verify: every on-minterm covered, no off-minterm covered."""
    X_on = np.asarray(X_on, dtype=np.uint8)
    X_off = np.asarray(X_off, dtype=np.uint8)
    if X_on.shape[0]:
        got = np.zeros(X_on.shape[0], dtype=bool)
        for m, v in cubes:
            got |= _covers(m, v, X_on)
        if not got.all():
            return False
    for m, v in cubes:
        if _covers(m, v, X_off).any():
            return False
    return True


def eval_sop(cubes, X: np.ndarray) -> np.ndarray:
    """Evaluate the SOP on rows of X -> bool (n,)."""
    X = np.asarray(X, dtype=np.uint8)
    out = np.zeros(X.shape[0], dtype=bool)
    for m, v in cubes:
        out |= _covers(m, v, X)
    return out


def _balanced_tree(graph: LogicGraph, op: OpCode, leaves: list[int],
                   cache: dict) -> int:
    """Hash-consed balanced reduction tree."""
    if not leaves:
        return CONST1 if op == OpCode.AND else CONST0
    nodes = leaves
    while len(nodes) > 1:
        nxt = []
        for j in range(0, len(nodes) - 1, 2):
            a, b = sorted((nodes[j], nodes[j + 1]))
            key = (int(op), a, b)
            if key not in cache:
                cache[key] = graph.add_gate(op, a, b)
            nxt.append(cache[key])
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def sop_to_graph(cube_sets: list[list[tuple[np.ndarray, np.ndarray]]],
                 n_inputs: int, name: str = "sop",
                 optimize="none") -> LogicGraph:
    """Factor one-or-more SOPs (sharing inputs) into a 2-input gate DAG.

    ``cube_sets[k]`` is the SOP of output k. Literals and AND/OR subtrees
    are shared across outputs via hash-consing. ``optimize`` routes the
    factored graph through the gate-level pass pipeline (core/opt.py:
    ``"default"`` | ``"none"`` | a ``PassManager``) for further
    sharing/depth reduction — the same default pipeline every synthesis
    consumer uses; ``"none"`` keeps the raw factoring (the doctests and
    the paper-exact scheduling contract).
    """
    g = LogicGraph(n_inputs, name=name)
    cache: dict = {}
    neg: dict[int, int] = {}

    def literal(i: int, value: int) -> int:
        w = g.input_wire(i)
        if value:
            return w
        if w not in neg:
            neg[w] = g.add_gate(OpCode.NOT, w)
        return neg[w]

    outputs = []
    for cubes in cube_sets:
        terms = []
        for mask, val in cubes:
            lits = [literal(int(i), int(val[i]))
                    for i in np.flatnonzero(mask)]
            terms.append(_balanced_tree(g, OpCode.AND, lits, cache))
        outputs.append(_balanced_tree(g, OpCode.OR, terms, cache))
    g.set_outputs(outputs)
    from repro_torch.core.opt import resolve_pipeline   # local import, no cycle
    pipeline = resolve_pipeline(optimize)
    return pipeline.run(g).graph if pipeline is not None else g
