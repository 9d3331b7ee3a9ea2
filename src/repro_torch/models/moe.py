"""Top-k MoE (Mixtral / Grok style) with sort-based capacity dispatch.

Port of ``src/repro/models/moe.py``.  Two dispatch paths, numerically
identical for tokens within capacity:

  * ``dense``  — every token through every expert, gate-weighted combine;
    the correctness oracle.
  * ``sorted`` — the production path, grouped per batch row (the
    reference vmaps it over the batch; here every op is batched over B):
    sort the (token, expert) assignments by expert, gather them into
    per-expert buffers of ``cap = ceil(k*S/E) * capacity_factor`` rows, run
    a batched (B, E, cap, d) x (E, d, ff) product, and gather back with the
    gate weights.  Assignments past an expert's capacity are dropped.

The dispatch and the combine are gathers both ways: their backward
(:class:`_RowGather`) gathers the gradient through the inverse map (each
token's k slots; each slot's one assignment) where autograd's own
backward of a gather is a scatter-add, whose atomics sum in no fixed
order on CUDA.  So the gradient of a token sums its k expert outputs in
choice order, on the card as on the CPU.

Expert weights are stacked (E, d, ff).  The reference's ``constrain``
calls (sharding annotations on the expert buffers) stand at its places;
without an active mesh they do nothing.  The router runs in float32 from the compute-dtype input, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.pspec_utils import constrain


def router_probs(params, x):
    """x (T, D) -> router logits (T, E) in float32."""
    return x.float() @ params["w_router"].float()


def _top_k_gates(logits: torch.Tensor, k: int):
    # a stable descending sort keeps the lower expert first among equal
    # logits, the tie-break of jax.lax.top_k (torch.topk promises none)
    gates, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    return torch.softmax(gates, dim=-1), idx      # renormalize top-k


def moe_dense(params, x, cfg):
    """Oracle: (B, S, D) -> (B, S, D), all experts computed."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    logits = router_probs(params, xf)
    gates, idx = _top_k_gates(logits, cfg.experts_per_token)
    # (T, E) combined gate weights
    comb = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                       device=x.device)
    comb.scatter_add_(1, idx, gates)
    g = torch.einsum("td,edf->tef", xf, params["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xf, params["w_up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.einsum("tef,efd->ted", h, params["w_down"].to(x.dtype))
    out = torch.einsum("ted,te->td", y.float(), comb)
    return out.to(x.dtype).reshape(b, s, d)


def capacity(cfg, s: int) -> int:
    """Per-row expert capacity of an S-token row (GShard semantics)."""
    k, e = cfg.experts_per_token, cfg.n_experts
    return max(1, int(-(-k * s // e) * cfg.capacity_factor))


def dispatch_plan(idx: torch.Tensor, e: int, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's routing plan, index tensors only, from its top-k
    assignments ``idx`` (B, S, k).  Returns
      inv     (B, E*cap) the token feeding each expert slot (S = none)
      a_slot  (B, S, k)  each assignment's buffer slot (E*cap = dropped)
      assign  (B, E*cap) the assignment (token * k + choice) feeding each
                         slot (S*k = none)
    An assignment's place in its expert's queue is its rank among that
    expert's assignments in (token, choice) order."""
    b, s, k = idx.shape
    dev = idx.device
    fe = idx.reshape(b, s * k)
    order = torch.argsort(fe, dim=-1, stable=True)
    se = torch.gather(fe, 1, order)
    pos = torch.arange(s * k, device=dev) - torch.searchsorted(
        se, se, side="left")
    slot = torch.where(pos < cap, se * cap + pos, e * cap)  # dummy overflow
    # every dropped assignment writes the dummy slot e*cap, the only index
    # written twice; it is sliced off, so the order of those writes does
    # not matter
    assign = torch.full((b, e * cap + 1), s * k, dtype=torch.int64,
                        device=dev).scatter_(1, slot, order)[:, :e * cap]
    inv = torch.where(assign < s * k, assign // k, s)
    a_slot = torch.zeros((b, s * k), dtype=torch.int64,
                         device=dev).scatter_(1, order, slot)
    return inv, a_slot.reshape(b, s, k), assign


def route(params, x, cfg):
    """The sorted path's routing of x (B, S, D): (gates (B, S, k) float32,
    idx (B, S, k), inv, a_slot, assign, cap); see :func:`dispatch_plan`."""
    b, s, d = x.shape
    e = cfg.n_experts
    cap = capacity(cfg, s)
    logits = router_probs(params, x.reshape(b * s, d)).reshape(b, s, e)
    gates, idx = _top_k_gates(logits, cfg.experts_per_token)
    return (gates, idx, *dispatch_plan(idx, e, cap), cap)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, M) -> (B, M, D): row idx[b, m] of x[b], a zero
    row where idx is N."""
    xpad = torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)
    return torch.gather(xpad, 1, idx[..., None].expand(-1, -1, x.shape[2]))


class _RowGather(torch.autograd.Function):
    """``_gather_rows(x, idx)`` whose backward is a gather too: ``back``
    (B, N, m) lists for each row of x the rows of the output it feeds (M
    where it feeds fewer than m), so the gradient of a row is the sum of
    those output rows' gradients, in the order ``back`` lists them."""

    @staticmethod
    def forward(ctx, x, idx, back):
        ctx.save_for_backward(back)
        return _gather_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        back, = ctx.saved_tensors
        b, n, m = back.shape
        rows = _gather_rows(g.contiguous(), back.reshape(b, n * m))
        return rows.reshape(b, n, m, -1).sum(dim=2), None, None


def moe_sorted(params, x, cfg):
    """Production path: grouped sort-based dispatch with capacity dropping
    (capacity per batch row)."""
    b, s, d = x.shape
    e = cfg.n_experts
    gates, _, inv, a_slot, assign, cap = route(params, x, cfg)
    # gather-based dispatch (token `s`, none, is the zero row); a token's
    # gradient gathers its k slots'
    buf = _RowGather.apply(x, inv, a_slot).reshape(b, e, cap, d)
    # the reference's layout constraints on the expert buffers
    buf = constrain(buf, "dp", None, None, None)
    g = constrain(torch.einsum("becd,edf->becf", buf,
                               params["w_gate"].to(x.dtype)),
                  "dp", None, None, "model")
    u = constrain(torch.einsum("becd,edf->becf", buf,
                               params["w_up"].to(x.dtype)),
                  "dp", None, None, "model")
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.einsum("becf,efd->becd", h, params["w_down"].to(x.dtype))
    y = constrain(y, "dp", None, None, None)
    # a dropped assignment points at the dummy zero row, so its gate weight
    # contributes nothing regardless of value; a slot's gradient gathers
    # its one assignment's
    contrib = _RowGather.apply(y.reshape(b, e * cap, d),
                               a_slot.reshape(b, -1), assign[..., None]
                               ).reshape(b, s, -1, d)      # (B, S, k, D)
    out = torch.einsum("bskd,bsk->bsd", contrib.float(), gates.float())
    return constrain(out.to(x.dtype), "dp", None, None)


def moe_forward(params, x, cfg):
    """The sorted path, or the dense one when every token takes every
    expert."""
    if cfg.experts_per_token >= cfg.n_experts:
        return moe_dense(params, x, cfg)
    return moe_sorted(params, x, cfg)


def aux_load_balance_loss(params, x, cfg) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean over batch)."""
    b, s, d = x.shape
    logits = router_probs(params, x.reshape(b * s, d))
    probs = torch.softmax(logits, dim=-1)
    _, idx = _top_k_gates(logits, cfg.experts_per_token)
    counts = torch.zeros((cfg.n_experts,), dtype=torch.float32,
                         device=x.device)
    counts.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(),
                                                     device=x.device))
    counts = counts / (b * s * cfg.experts_per_token)
    imp = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(counts * imp)
