"""The traffic generator every mix is read with.

Every payload is made before the window: a request's bits are a view into
one pool of the configuration's input patterns, drawn from the run seed,
and no bits are generated while the window runs.  The seed draws which
pattern each pool row holds, each request's offset into the pool and,
for a mix of ragged requests, each request's size.

Request sizes follow the port's ``serve/traffic.py`` (geometric with a
stated mean, capped); its open-loop schedule (``TrafficPattern``,
``build_trace``) is not copied until a cell offers open-loop load.
"""
from __future__ import annotations

import numpy as np


def sizes(size_mean: float, size_max: int, n: int,
          rng: np.random.Generator) -> np.ndarray:
    """Geometric request sizes with mean ``size_mean``, at most
    ``size_max`` (ragged: rarely multiples of 32)."""
    return np.minimum(rng.geometric(1.0 / max(1.0, size_mean), n), size_max)


def pattern_pool(n_patterns: int, rows: int, seed) -> np.ndarray:
    """Which input pattern each row of the payload pool holds."""
    return np.random.default_rng(seed).integers(0, n_patterns, rows)


def offsets(pool_rows: int, n: np.ndarray,
            rng: np.random.Generator) -> np.ndarray:
    """A start row in the pool for each request of ``n`` samples."""
    return (rng.random(len(n)) * (pool_rows - n + 1)).astype(np.int64)
