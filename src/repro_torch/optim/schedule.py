"""LR schedules. WSD (warmup-stable-decay) is MiniCPM's schedule
[arXiv:2404.06395], the recipe of the minicpm-2b architecture.

Port of ``src/repro/optim/schedule.py``.  Each schedule maps a step (an
int or a tensor) to the learning rate as a 0-d float32 tensor on the CPU,
computed in float32 op for op as the reference computes it on jnp scalars,
so the rates agree to rounding; ``float()`` of it is what an update
multiplies by.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    s = _f32(step)
    return peak * torch.minimum(_f32(1.0), s / max(1, warmup_steps))


def wsd_schedule(peak: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, final_frac: float = 0.1):
    """Warmup -> Stable (constant) -> Decay (exponential-ish to final_frac)."""

    def fn(step) -> torch.Tensor:
        s = _f32(step)
        warm = peak * torch.minimum(_f32(1.0), s / max(1, warmup_steps))
        in_decay = torch.clamp(s - (warmup_steps + stable_steps), min=0.0)
        frac = torch.minimum(_f32(1.0), in_decay / max(1, decay_steps))
        decay_mult = torch.pow(_f32(final_frac), frac)    # 1 -> final_frac
        return torch.where(s < warmup_steps, warm, peak * decay_mult)

    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step) -> torch.Tensor:
        s = _f32(step)
        warm = peak * torch.minimum(_f32(1.0), s / max(1, warmup_steps))
        prog = torch.clamp((s - warmup_steps) /
                           max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return fn
