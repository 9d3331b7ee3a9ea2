"""RG-LRU recurrence (Griffin / RecurrentGemma) [arXiv:2402.19427].

Port of ``src/repro/models/rglru.py``:

    r_t = sigmoid(W_a x_t + b_a)                 (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                 (input gate)
    a_t = exp(c * r_t * log(sigmoid(Lambda)))    (= a^{c r_t}, a in (0,1))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Every gate and sum is float32, as in the reference.  Train / prefill scan
the pairs ``(a, g)`` in log depth: PyTorch has no ``associative_scan``, so
:func:`rglru_scan` is the doubling (Hillis-Steele) scan, ⌈log2 S⌉ tensor
steps over the whole sequence, with the same combine as the reference's.
The sums run in another order than XLA's tree, so the two agree to float32
rounding.  Decode is one step on a carried state; :func:`rglru_reference`
is the sequential oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gates(params, x):
    r = torch.sigmoid(x.float() @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(x.float() @ params["w_x"].float() + params["b_x"])
    return r, i


def _log_a(params, r, c: float):
    # log a_t = c * r_t * log sigmoid(Lambda)   (<= 0)
    log_lam = F.logsigmoid(params["lam"].float())
    return c * r * log_lam[None, None, :]


def rglru_scan(params, x: torch.Tensor, c: float = 8.0,
               init_h: torch.Tensor | None = None,
               gate_x: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D_rnn) -> (h (B, S, D_rnn) in x's dtype, final h (B,
    D_rnn) float32).  Under tensor parallelism ``x`` is a block of the
    channels, ``gate_x`` the whole width the gates read (``w_a`` and
    ``w_x`` split by column); by default ``x`` itself."""
    s = x.shape[1]
    r, i = _gates(params, x if gate_x is None else gate_x)
    a = torch.exp(_log_a(params, r, c))                    # (B,S,D)
    g = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    if init_h is not None:
        g = torch.cat([g[:, :1] + a[:, :1] * init_h.float()[:, None],
                       g[:, 1:]], dim=1)
    # h_t = a_t h_{t-1} + g_t: associative over pairs (a, g):
    #   (a2, g2) o (a1, g1) = (a1*a2, a2*g1 + g2)
    # each step folds the prefix ending `shift` earlier into every entry
    shift = 1
    while shift < s:
        g = torch.cat([g[:, :shift], a[:, shift:] * g[:, :-shift] +
                       g[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return g.to(x.dtype), g[:, -1].float()


def rglru_step(params, x_t: torch.Tensor, h_prev: torch.Tensor,
               c: float = 8.0, gate_x: torch.Tensor | None = None
               ) -> torch.Tensor:
    """One decode step: x_t (B, D_rnn), h_prev (B, D_rnn) -> h_t
    (float32); ``gate_x`` as in :func:`rglru_scan`."""
    gx = x_t if gate_x is None else gate_x
    r, i = _gates(params, gx[:, None, :])
    a = torch.exp(_log_a(params, r, c)[:, 0])
    g = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i[:, 0] * x_t.float())
    return a * h_prev.float() + g


def rglru_reference(params, x: torch.Tensor, c: float = 8.0) -> torch.Tensor:
    """Sequential oracle."""
    h = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                    device=x.device)
    out = []
    for t in range(x.shape[1]):
        h = rglru_step(params, x[:, t], h, c)
        out.append(h)
    return torch.stack(out, dim=1).to(x.dtype)


def temporal_conv(params, x: torch.Tensor, width: int,
                  carry: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d over x (B, S, D) with ``conv_w`` (width,
    D); ``carry`` (B, width-1, D) holds the inputs before x (zeros when
    None).  Returns the output in x's dtype (summed in float32) and the
    carry for the next call: the last width-1 inputs."""
    b, s, d = x.shape
    w = params["conv_w"].float()                           # (width, D)
    if carry is None:
        carry = torch.zeros((b, width - 1, d), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([carry.to(x.dtype), x], dim=1)
    out = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    for k in range(width):
        out = out + xx[:, k:k + s].float() * w[k]
    new_carry = xx[:, xx.shape[1] - (width - 1):]
    return out.to(x.dtype), new_carry
