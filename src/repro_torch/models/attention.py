"""Attention: GQA + qk-norm + sliding window + cached decode.

Port of ``src/repro/models/attention.py`` as plain functions on tensors;
``params`` is a dict of one layer's attention weights (``wq``, ``wk``,
``wv``, ``wo`` and, with ``cfg.qk_norm``, ``q_norm`` / ``k_norm``).

Shapes: x (B, S, D); q heads H, kv heads Hk (H % Hk == 0); head_dim hd.
Full attention (train / prefill) repeats K/V to the H query heads before
the scores, as the reference does; decode is grouped, q reshaped
(B, 1, Hk, G, hd) against the cache (B, C, Hk, hd).  Scores and softmax
are float32, masked with ``NEG_INF``; the softmax weights are cast back to
the compute dtype before they meet V, at the reference's cast points.

Decode: the KV cache is (B, C, Hk, hd) per layer.  For sliding-window
configs it is a ring buffer of C = window entries: token ``pos`` lands in
slot ``pos % C``, and once the ring has wrapped every entry is live.
Unlike the reference, which returns a new cache, :func:`attention_decode`
writes its one slot in place (the cache is the largest state of a decode
step, and nothing reads the old one), and the cache's ``length`` is a host
integer rather than a device scalar.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import DTYPES, apply_rope, rms_norm
from repro_torch.models.pspec_utils import (active_mesh, constrain,
                                            dp_axes, mesh_axes)

NEG_INF = -1e30


def _constrain_qkv(q, k, v, cfg):
    """In-attention layout choice, the reference's: if the head count
    divides the 'model' axis, leave the heads to their sharding;
    otherwise shard the query sequence over 'model' (sequence-parallel
    attention: keys/values gathered, queries local).  These annotations
    redistribute DTensors only; under tensor parallelism on plain tensors
    the same layout is :func:`attend_seq_parallel`."""
    mesh = active_mesh()
    if mesh is None:
        return q, k, v
    mesh = mesh_axes(mesh)
    if "model" not in mesh.axis_names or "model" in dp_axes():
        return q, k, v
    model = mesh.shape["model"]
    if cfg.n_heads % model == 0:
        return q, k, v
    q = constrain(q, "dp", "model", None, None)
    k = constrain(k, "dp", None, None, None)
    v = constrain(v, "dp", None, None, None)
    return q, k, v


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, C, Hk, hd)
    v: torch.Tensor       # (B, C, Hk, hd)
    length: int           # tokens written so far (ring slot = length % C)


def init_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
               dtype: torch.dtype, device=None) -> KVCache:
    shape = (batch, capacity, n_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def qk_norm(q: torch.Tensor, k: torch.Tensor,
            params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """qwen3's per-head RMS norm of queries and keys."""
    return rms_norm(q, params["q_norm"]), rms_norm(k, params["k_norm"])


def _qkv(params, x, cfg):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q, k = qk_norm(q, k, params)
    return q, k, v


def _scores_out(q, k, v, cfg, qpos, kpos, causal, window):
    """Softmax attention of queries ``q`` (B, S, H, hd) at positions
    ``qpos`` (B, S) over keys and values (B, T, Hk, hd) at ``kpos`` (B,
    T): (B, S, H * hd)."""
    b, s = q.shape[:2]
    hd = cfg.resolved_head_dim
    g = cfg.q_per_kv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)       # (B, T, H, hd)
        v = torch.repeat_interleave(v, g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * (hd ** -0.5),
                          k.float())                   # (B, H, S, T)
    ii = qpos[:, :, None]                              # (B, S, 1) query pos
    jj = kpos[:, None, :]                              # (B, 1, T) key pos
    if causal:
        mask = jj <= ii
        if window:
            mask &= jj > ii - window
    else:
        mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool,
                          device=q.device)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v).reshape(
        b, s, cfg.n_heads * hd)


def _attend(params, x, cfg, positions, causal, window):
    """Full attention; returns the output and the roped K and V before
    they are repeated to the query heads (what the cache stores)."""
    q, k, v = _constrain_qkv(*_qkv(params, x, cfg), cfg)
    if not cfg.is_encoder:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = _scores_out(q, k, v, cfg, positions, positions, causal, window)
    return out @ params["wo"].to(x.dtype), k, v


def attend_seq_parallel(params, x, cfg, positions, causal, window, tp):
    """Sequence-parallel attention (the reference's ``_constrain_qkv``
    where the heads do not divide 'model'): ``x`` (B, S / size, D) is
    this rank of ``tp``'s block of the sequence, ``positions`` (B, S) the
    whole sequence's, and the weights are whole.  The queries, keys and
    values are projected on the block; the keys and values are
    all-gathered by sequence (their gradient reduce-scattered back), the
    queries stay local, and the mask is by position.  Returns this rank's
    block of the output (B, S / size, D) and the whole sequence's roped K
    and V."""
    s = x.shape[1]
    qpos = positions[:, tp.rank * s:(tp.rank + 1) * s]
    q, k, v = _qkv(params, x, cfg)
    if not cfg.is_encoder:
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)
    k, v = tp.gather(k, 1), tp.gather(v, 1)
    out = _scores_out(q, k, v, cfg, qpos, positions, causal, window)
    return out @ params["wo"].to(x.dtype), k, v


def attention_decode(params: dict, x: torch.Tensor, cfg, cache: KVCache, *,
                     window: int = 0) -> tuple[torch.Tensor, KVCache]:
    """One-token decode step, x: (B, 1, D).  Writes the token's K and V
    into slot ``length % C`` of ``cache`` in place; returns the output and
    the cache with ``length + 1``."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"a decode step takes one token, got {s}")
    hd = cfg.resolved_head_dim
    hk, g = cfg.n_kv_heads, cfg.q_per_kv
    cap = cache.k.shape[1]
    pos = cache.length
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, cfg)
    if not cfg.is_encoder:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    slot = pos % cap
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    # validity: entry t is live iff written; after the ring wraps, all are
    if pos + 1 >= cap:
        live = torch.ones(cap, dtype=torch.bool, device=x.device)
    else:
        live = torch.arange(cap, device=x.device) <= slot
    qg = q.reshape(b, 1, hk, g, hd).float() * (hd ** -0.5)
    scores = torch.einsum("bshgd,bthd->bhgst", qg,
                          cache.k.float())             # (B, Hk, G, 1, C)
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    z = e.sum(dim=-1, keepdim=True)
    w = (e / z).to(x.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", w, cache.v).reshape(
        b, 1, cfg.n_heads * hd)
    out = out @ params["wo"].to(x.dtype)
    return out, cache._replace(length=pos + 1)


def cache_of(k: torch.Tensor, v: torch.Tensor, capacity: int,
             dtype: torch.dtype) -> KVCache:
    """The decode cache of a prompt's roped keys and values (B, S, Hk,
    hd): the last ``capacity`` of them, in ring layout when the prompt is
    longer than the cache."""
    s = k.shape[1]
    if capacity >= s:
        pad = capacity - s
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    else:  # keep the most recent `capacity` (ring layout, slot=s%cap aligned)
        kc = k[:, s - capacity:]
        vc = v[:, s - capacity:]
        # rotate so that entry (t mod cap) sits at index t mod cap
        shift = (s - capacity) % capacity
        kc = torch.roll(kc, shift, dims=1)
        vc = torch.roll(vc, shift, dims=1)
    return KVCache(k=kc.to(dtype).contiguous(), v=vc.to(dtype).contiguous(),
                   length=s)


def cfg_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]
