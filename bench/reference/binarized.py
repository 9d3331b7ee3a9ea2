"""The binarized layers a configuration deploys, computed plainly.

Neuron ``j`` of a layer fires iff ``(2x - 1) @ W[:, j] + b[j] >= 0``.
A synthesized NullaNet program equals its layer exactly on the patterns
its ISF was sampled on, and is whatever synthesis chose elsewhere; the
benchmark serves only those patterns, so on every served sample the
program's bits and these are the same bits.  For a stack, each layer's
ISF is sampled on the previous layer's outputs over the same patterns, so
the stack is exact on the first layer's patterns too.

The weights are float32 and the sums are taken in float64: the terms are
+-float32 values, which float64 adds exactly in any order.
"""
from __future__ import annotations

import numpy as np


def binarize(x01: np.ndarray, W: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One layer's 0/1 outputs (uint8) for 0/1 inputs ``x01``."""
    pm1 = 2.0 * np.asarray(x01, dtype=np.float64) - 1.0
    return ((pm1 @ W.astype(np.float64) + b.astype(np.float64)) >= 0
            ).astype(np.uint8)


def stack(x01: np.ndarray, layers) -> np.ndarray:
    """The last layer's outputs (bool) of the whole stack."""
    h = np.asarray(x01, dtype=np.uint8)
    for layer in layers:
        h = binarize(h, layer.W, layer.b)
    return h.astype(bool)


def pattern_table(layers, rows: int = 4096) -> np.ndarray:
    """The stack's outputs on every pattern of the first layer, computed
    in blocks of ``rows``: row ``i`` is what a sample holding pattern
    ``i`` must be served."""
    patterns = layers[0].patterns
    return np.concatenate([stack(patterns[i:i + rows], layers)
                           for i in range(0, len(patterns), rows)])
