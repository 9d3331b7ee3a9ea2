"""Mamba-2 / SSD (state-space duality) block [arXiv:2405.21060].

Port of ``src/repro/models/mamba2.py``.  Chunked SSD: the sequence is cut
into chunks of Q tokens; within a chunk the output is a causal,
decay-weighted quadratic form, and across chunks a small state (H, P, N)
is carried.  The reference carries it with ``lax.scan``; here it is a
Python loop over the chunks that emits each chunk's pre-state.  Decode is
one step: state <- decay * state + dt*B (x) x;  y = C . state.  Every sum
is float32, as in the reference.

Multi-value layout as in the paper: B and C are shared across heads
(n_groups = 1), A is a scalar per head, x has (H, P) heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or (d_in // cfg.ssm_head_dim)
    return d_in, nh, cfg.ssm_head_dim, cfg.ssm_state


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    out[i, j] = sum_{k=j+1..i} log_a[k] for i >= j, -inf otherwise (exp
    takes it to 0)."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]       # sum_{j+1..i}
    ii = torch.arange(q, device=log_a.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.

    Args:
      x: (B, S, H, P) inputs. dt: (B, S, H) positive step sizes.
      a_log: (H,) log of -A (A negative) -> per-step decay exp(-dt*exp(a_log)).
      bmat/cmat: (B, S, N) shared across heads.
      chunk: Q.
    Returns: (y (B, S, H, P) float32, final_state (B, H, P, N) float32).
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    s_out = s
    pad = (-s) % chunk
    if pad:
        # zero-pad the tail: dt=0 -> decay=1 and zero input, so the carried
        # state is untouched; padded outputs are sliced off below.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    # per-step log decay: -dt * exp(a_log)  (negative)
    log_a = -dt.float() * torch.exp(a_log.float())[None, None, :]  # (B,S,H)
    xdt = x.float() * dt.float()[..., None]

    # chunked views: (B, NC, Q, ...)
    def ch(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, lac = ch(xdt), ch(log_a)
    bc, cc = ch(bmat.float()), ch(cmat.float())

    # --- intra-chunk (diagonal blocks): decay-masked quadratic form ---
    decay = torch.exp(_segsum(lac.permute(0, 1, 3, 2)))  # (B,NC,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)     # (B,NC,Q,Q)
    w = scores[:, :, None] * decay                       # (B,NC,H,Q,Q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", w, xc)

    # --- chunk states: decay-to-end weighted sum of B (x) x ---
    la_sum = lac.sum(dim=2)                              # (B,NC,H)
    decay_to_end = torch.exp(la_sum[:, :, None, :] -
                             torch.cumsum(lac, dim=2))   # (B,NC,Q,H)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                          decay_to_end, bc, xc)          # (B,NC,H,P,N)

    # --- inter-chunk recurrence: a loop over chunks emitting PRE-states ---
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    chunk_decay = torch.exp(la_sum)                      # (B,NC,H)
    pre = []
    for c in range(nc):
        pre.append(state)
        state = states[:, c] + chunk_decay[:, c, :, None, None] * state
    pre_states = torch.stack(pre, dim=1)                 # (B,NC,H,P,N)

    # --- inter-chunk contribution: C . decayed carried state ---
    decay_from_start = torch.exp(torch.cumsum(lac, dim=2))  # (B,NC,Q,H)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp",
                         cc, decay_from_start, pre_states)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :s_out], state


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    bvec: torch.Tensor, cvec: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B,H,P), dt (B,H), bvec/cvec (B,N), state (B,H,P,N)."""
    decay = torch.exp(-dt.float() * torch.exp(a_log.float())[None, :])
    xdt = x.float() * dt.float()[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xdt, bvec.float())
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cvec.float())
    return y, new_state


def ssd_reference(x, dt, a_log, bmat, cmat):
    """O(S) sequential oracle for tests: plain per-token recurrence."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(x[:, t], dt[:, t], a_log, bmat[:, t],
                                   cmat[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state
