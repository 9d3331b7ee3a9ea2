"""AdamW with decoupled weight decay over a dict of parameters.

Port of ``src/repro/optim/adamw.py``.  Moments are stored in
``moment_dtype`` (float32 by default; bfloat16 halves the optimizer
state), keyed like the parameters.  The arithmetic is the reference's:
float32 bias corrections from the *new* step, and
``p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)`` in float32, cast
back to the parameter's dtype.  That is not ``torch.optim.AdamW``, which
decays ``p * (1 - lr * wd)`` and keeps its state in the parameter's dtype.

Unlike the reference, which returns new trees, :func:`adamw_update`
writes the parameters and moments in place under ``torch.no_grad()``
(they are the largest state of a step and nothing reads the old values),
and returns them with the state's ``step`` advanced.  The step is a host
integer, not a device scalar, so no update synchronizes on it.  The
update walks the leaves one at a time in eager PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int             # updates applied so far
    mu: dict              # name -> tensor, like the params
    nu: dict


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_moment_dtype(name: str) -> torch.dtype:
    """Config string -> torch dtype of the moment buffers."""
    try:
        return _MOMENT_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown moment_dtype {name!r}; "
            f"use one of {sorted(_MOMENT_DTYPES)}") from None


def adamw_init(params: dict, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments beside each parameter, on its device."""

    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return AdamWState(step=0, mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()})


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> tuple[dict, AdamWState]:
    """Update ``params`` and the moments in place from ``grads``; returns
    ``(params, state with step + 1)``.  ``lr`` is a scalar or a
    callable(step) (a schedule of ``optim/schedule.py``)."""
    step = state.step + 1
    lr_t = float(lr(step) if callable(lr) else lr)
    s = torch.tensor(step, dtype=torch.float32)
    b1c = float(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), s))
    b2c = float(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), s))
    for k, p in params.items():
        g32 = grads[k].float()
        mu, nu = state.mu[k], state.nu[k]
        mu_n = b1 * mu.float() + (1 - b1) * g32
        nu_n = b2 * nu.float() + (1 - b2) * g32 * g32
        delta = (mu_n / b1c) / (torch.sqrt(nu_n / b2c) + eps) + \
            weight_decay * p.float()
        p.copy_(p.float() - lr_t * delta)
        mu.copy_(mu_n)
        nu.copy_(nu_n)
    return params, state._replace(step=step)
