"""Shared layers: norms, RoPE, FFNs, the loss and init helpers.

Port of ``src/repro/models/layers.py`` as plain functions on tensors.  Each
mirrors the reference's cast points (float32 for the norm statistics, the
rotation and the activations, cast back to the input's dtype where the
reference casts), because in bf16 a cast moved by one op changes the
logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


# ---------------------------------------------------------------------------
# init (each fills a parameter in place from ``generator``)
# ---------------------------------------------------------------------------

def normal_init(param: torch.Tensor, generator: torch.Generator,
                scale: float = 0.02) -> None:
    """N(0, 1) drawn in float32 on the parameter's device, times
    ``scale``, cast to the parameter's dtype (as the reference draws)."""
    draw = torch.randn(param.shape, generator=generator,
                       dtype=torch.float32, device=param.device)
    param.copy_(draw * scale)


def zeros_init(param: torch.Tensor, generator=None) -> None:
    param.zero_()


def ones_init(param: torch.Tensor, generator=None) -> None:
    param.fill_(1.0)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    half-split rotation, computed in float32 and cast back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu((x @ w_in.to(x.dtype)).float(), approximate="tanh")
    return h.to(x.dtype) @ w_out.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) in float32, labels int.  The
    gold logit is a masked sum over the vocabulary, as in the reference."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    hit = iota == labels[..., None]
    gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
