"""Global-norm gradient clipping.

Port of ``src/repro/optim/clip.py`` over a dict of gradient tensors: the
norm is taken in float32 over every leaf, and each leaf is scaled in
float32 and cast back to its own dtype.
"""
from __future__ import annotations

import torch


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (0-d, on the
    leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """(grads scaled by ``min(1, max_norm / (norm + 1e-12))``, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, norm
