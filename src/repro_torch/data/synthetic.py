# make_binary_classification and train_val_split copied verbatim from
# src/repro/data/synthetic.py; its TokenPipeline (the LM scaffold's token
# stream) is not part of this package.
"""Deterministic synthetic data for the NullaNet experiments (paper §8:
MNIST / CIFAR-10 are not available offline): prototype-based binary
feature vectors with controlled noise, learnable by a small binarized MLP,
so the NN -> FFCL -> logic-inference accuracy-parity study is real.
"""
from __future__ import annotations

import numpy as np


def make_binary_classification(n_samples: int, n_features: int,
                               n_classes: int = 10, noise: float = 0.08,
                               seed: int = 0
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Binary {0,1} features from class prototypes with iid bit-flip noise."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 2, size=(n_classes, n_features), dtype=np.int64)
    y = rng.integers(0, n_classes, size=n_samples)
    x = protos[y]
    flips = rng.random((n_samples, n_features)) < noise
    x = np.where(flips, 1 - x, x)
    return x.astype(np.uint8), y.astype(np.int64)


def train_val_split(x: np.ndarray, y: np.ndarray, val_frac: float = 0.25,
                    seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic shuffled split -> (x_train, y_train, x_val, y_val)."""
    if not 0.0 < val_frac < 1.0:
        raise ValueError(f"val_frac must be in (0, 1), got {val_frac}")
    n = len(x)
    perm = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(round(n * val_frac)))
    tr, va = perm[:-n_val], perm[-n_val:]
    return x[tr], y[tr], x[va], y[va]
