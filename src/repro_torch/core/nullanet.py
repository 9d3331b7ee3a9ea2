# The numpy half of src/repro/core/nullanet.py (ENUM_LIMIT, neuron_isf,
# neuron_enumerated, layer_to_graph), copied verbatim; the torch training
# half is not part of this package yet.
"""NullaNet flow (paper §7): binarized NN -> per-neuron Boolean functions.

Per neuron, form a Boolean specification either by *input enumeration*
(fanin <= ``ENUM_LIMIT``) or as an *incompletely specified function* (ISF)
sampled on the training set; run two-level minimization; factor into
2-input gates -> LogicGraph -> the FFCL compiler (scheduler.py).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import espresso
from repro_torch.core.gate_ir import LogicGraph

ENUM_LIMIT = 14  # paper §7.1: enumeration applicable to <= ~14 inputs


# ---------------------------------------------------------------------------
# Boolean specification extraction
# ---------------------------------------------------------------------------

def neuron_isf(x_bits: np.ndarray, w: np.ndarray, b: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """ISF of one neuron sampled on observed inputs (paper §7.1).

    x_bits: (N, fanin) {0,1}. Neuron fires iff (2x-1)@w + b >= 0.
    Returns deduplicated (X_on, X_off) minterm arrays.
    """
    x_bits = np.asarray(x_bits, dtype=np.uint8)
    acts = ((2.0 * x_bits - 1.0) @ np.asarray(w) + b) >= 0
    pats, idx = np.unique(x_bits, axis=0, return_index=True)
    out = acts[idx]
    return pats[out], pats[~out]


def neuron_enumerated(w: np.ndarray, b: float) -> tuple[np.ndarray, np.ndarray]:
    """Complete truth table by input enumeration (fanin <= ENUM_LIMIT)."""
    fanin = len(w)
    if fanin > ENUM_LIMIT:
        raise ValueError(f"enumeration limited to {ENUM_LIMIT} inputs")
    pats = ((np.arange(2 ** fanin)[:, None] >>
             np.arange(fanin)[None, :]) & 1).astype(np.uint8)
    acts = ((2.0 * pats - 1.0) @ np.asarray(w) + b) >= 0
    return pats[acts], pats[~acts]


def layer_to_graph(x_bits: np.ndarray, W: np.ndarray, b: np.ndarray,
                   mode: str = "auto", name: str = "layer",
                   optimize="default") -> LogicGraph:
    """Convert one binarized layer (all neurons, shared inputs) to a graph.

    mode: 'isf' | 'enum' | 'auto' (enum when fanin <= ENUM_LIMIT).
    optimize: gate-level optimization of the factored graph —
      ``"default"`` (the core/opt.py default pipeline), ``"none"`` (raw
      espresso factoring), or a :class:`~repro.core.opt.PassManager`.
    """
    fanin, n_neurons = W.shape
    if mode == "auto":
        mode = "enum" if fanin <= ENUM_LIMIT else "isf"
    cube_sets = []
    for j in range(n_neurons):
        if mode == "enum":
            x_on, x_off = neuron_enumerated(W[:, j], float(b[j]))
        else:
            x_on, x_off = neuron_isf(x_bits, W[:, j], float(b[j]))
        cubes = espresso.minimize(x_on, x_off)
        assert espresso.check_cover(cubes, x_on, x_off), \
            f"minimization broke neuron {j}"
        cube_sets.append(cubes)
    return espresso.sop_to_graph(cube_sets, n_inputs=fanin, name=name,
                                 optimize=optimize)
