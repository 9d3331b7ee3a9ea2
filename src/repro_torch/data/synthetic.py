# Copied from src/repro/data/synthetic.py: the NullaNet experiments' data
# and the LM's token stream.
"""Deterministic synthetic data pipelines.

Two consumers:
  * NullaNet experiments (paper §8: MNIST / CIFAR-10 are not available
    offline) -> ``make_binary_classification``: prototype-based binary
    feature vectors with controlled noise; learnable by a small binarized
    MLP, so the NN->FFCL->logic-inference accuracy-parity study is real.
  * LM training (examples + trainer tests) -> ``TokenPipeline``: a
    stateless-seekable token stream (seed, step) -> batch, so restarts and
    elastic re-sharding replay the exact same data (fault-tolerance story).
"""
from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class TokenPipeline:
    """Stateless-seekable synthetic token stream.

    ``batch(step)`` is a pure function of (seed, step, shape) — a restart at
    step k regenerates the identical batch k, and any host can materialize
    just its shard (host-sharded loading at scale: each host slices
    [host_id::n_hosts] of the global batch).
    """

    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1
              ) -> dict[str, np.ndarray]:
        if self.global_batch % n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        per_host = self.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id]))
        # Markov-ish structure so loss actually decreases during training.
        base = rng.integers(0, self.vocab_size,
                            size=(per_host, self.seq_len), dtype=np.int64)
        shifted = np.roll(base, 1, axis=1)
        mix = rng.random((per_host, self.seq_len)) < 0.5
        tokens = np.where(mix, (shifted * 31 + 7) % self.vocab_size, base)
        return {"tokens": tokens.astype(np.int32)}


def synthetic_tokens(step: int, *, vocab_size: int, global_batch: int,
                     seq_len: int, seed: int = 0) -> np.ndarray:
    return TokenPipeline(vocab_size, global_batch, seq_len,
                         seed).batch(step)["tokens"]
