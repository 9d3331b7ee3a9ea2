"""Serving: per-family decode caches, prefill, and single-token decode.

Port of ``src/repro/serve/engine.py``.  Cache layouts:

  dense/moe/vlm : KV (L, B, C, Hk, hd) with C = min(context, window) for
                  sliding-window configs (a ring buffer, see
                  ``models/attention.py``).
  ssm           : state (L, B, H, P, N) float32 + conv carry (L, B, W-1,
                  CH): O(1) in the context.
  hybrid        : KV over the attention layers only (C = min(context,
                  local_window)) + the RG-LRU h-state (float32) and conv
                  carry over the recurrent layers.
  audio         : encoder-only: no decode (refused).

``prefill`` runs the full forward over the prompt once and fills every
layer's cache; ``decode_step`` advances one token.  On the vlm path the
prompt is the stub patch embeddings (``vision=``) then the tokens, and the
positions and ``length`` count the vision tokens.  The reference scans
over stacked layer parameters; here both walk the model's blocks in a
Python loop, and a decode step writes each layer's slot of every cache
tensor in place (the returned cache holds the same tensors with ``length
+ 1``).  Both run under ``torch.inference_mode()``: the model's forward
records autograd where grad is enabled (training), and serving enters
inference mode itself.  The reference's sharding annotations stand at
its places (``models/pspec_utils.constrain``); without an active mesh
they do nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.logic_dsp.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, rglru
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.pspec_utils import constrain
from repro_torch.models.transformer import (_LRU_KEYS, Block, Transformer,
                                            _cdtype, _rec_gate,
                                            _ssm_mix, layer_kinds)


class DecodeCache(NamedTuple):
    kv_k: torch.Tensor | None = None        # (La, B, C, Hk, hd)
    kv_v: torch.Tensor | None = None
    ssm_state: torch.Tensor | None = None   # (Ls, B, H, P, N) float32
    conv_carry: torch.Tensor | None = None  # (Ls, B, W-1, CH)
    rec_h: torch.Tensor | None = None       # (Lr, B, D_rnn) float32
    rec_conv: torch.Tensor | None = None    # (Lr, B, W-1, D_rnn)
    length: int = 0                         # tokens so far


def cache_capacity(cfg: ModelConfig, context: int) -> int:
    if cfg.sliding_window:
        return min(context, cfg.sliding_window)
    if cfg.family == "hybrid" and cfg.local_window:
        return min(context, cfg.local_window)
    return context


def _check_decoder(cfg: ModelConfig) -> None:
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode")


def decode_cache_shapes(cfg: ModelConfig, batch: int, context: int
                        ) -> dict:
    """The shape and dtype of each tensor of a :class:`DecodeCache`, by
    field (the fields the family's cache holds).  Refuses an encoder."""
    _check_decoder(cfg)
    dt = _cdtype(cfg)
    kinds = layer_kinds(cfg)
    n_attn = sum(1 for k in kinds if k in ("dense", "moe"))
    n_ssm, n_rec = kinds.count("ssm"), kinds.count("rec")
    out = {}
    if n_attn:
        shape = (n_attn, batch, cache_capacity(cfg, context),
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        out["kv_k"] = out["kv_v"] = (shape, dt)
    if n_ssm:
        d_in, nh, p, n = mamba2.ssm_dims(cfg)
        out["ssm_state"] = ((n_ssm, batch, nh, p, n), torch.float32)
        out["conv_carry"] = ((n_ssm, batch, cfg.ssm_conv_width - 1,
                              d_in + 2 * n), dt)
    if n_rec:
        d_rnn = cfg.n_heads * cfg.resolved_head_dim
        out["rec_h"] = ((n_rec, batch, d_rnn), torch.float32)
        out["rec_conv"] = ((n_rec, batch, cfg.ssm_conv_width - 1, d_rnn),
                           dt)
    return out


def init_decode_cache(cfg: ModelConfig, batch: int, context: int,
                      device=None) -> DecodeCache:
    """An empty cache on ``device`` (CUDA unless ``"cpu"``; the model's
    device for :func:`decode_step`).  Refuses an encoder."""
    shapes = decode_cache_shapes(cfg, batch, context)
    device = resolve_device(device)
    return DecodeCache(**{k: torch.zeros(shape, dtype=dt, device=device)
                          for k, (shape, dt) in shapes.items()})


# ---------------------------------------------------------------------------
# per-kind single-token block steps
# ---------------------------------------------------------------------------

def _attn_block_step(blk: Block, x, cfg, kv: KVCache):
    """One attention block (dense or MoE FFN) on one token; the layer's
    cache slot is written in place."""
    p = blk.params()
    h = rms_norm(x, p["attn_norm"])
    h, _ = attn.attention_decode(p, h, cfg, kv, window=blk.window)
    x = x + h
    h = rms_norm(x, p["mlp_norm"])
    return x + blk.ffn(p, h)


def _ssm_block_step(blk: Block, x, cfg, state, carry):
    """x (B, 1, D). Single-token SSD step; returns (x, state, carry)."""
    p = blk.params()
    b = x.shape[0]
    d_in, nh, hp, n = mamba2.ssm_dims(cfg)
    h = rms_norm(x, p["norm"])
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [d_in, d_in, n, n, nh],
                                         dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out, carry = rglru.temporal_conv(
        {"conv_w": p["conv_w"]}, conv_in, cfg.ssm_conv_width, carry)
    conv_out = F.silu(conv_out.float()).to(h.dtype)
    xin, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xin[:, 0].reshape(b, nh, hp)
    y, state = mamba2.ssd_decode_step(xh, dt[:, 0], p["a_log"], bmat[:, 0],
                                      cmat[:, 0], state)
    y = y + xh.float() * p["skip_d"].float()[None, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["out_norm"])
    return x + y @ p["out_proj"].to(x.dtype), state, carry


def _rec_block_step(blk: Block, x, cfg, h_state, carry):
    """One RG-LRU block on one token; returns (x, h_state, carry).  Under
    tensor parallelism (``blk.tp``) the states are this rank's ``d_rnn``
    block, the conv's output is gathered for the gates and the products
    leave through the group's all-reduce."""
    p = blk.params()
    h = blk._tp_in(rms_norm(x, p["attn_norm"]))
    gate = _rec_gate(p, h)
    u = h @ p["rnn_proj"].to(h.dtype)
    u, carry = rglru.temporal_conv({"conv_w": p["conv_w"]}, u,
                                   cfg.ssm_conv_width, carry)
    gate_x = None if blk.tp is None else blk.tp.gather(u[:, 0], -1)
    h_state = rglru.rglru_step({k: p[k] for k in _LRU_KEYS}, u[:, 0],
                               h_state, cfg.rglru_c, gate_x)
    y = (gate * h_state[:, None].to(gate.dtype)) @ p["out_proj"].to(x.dtype)
    x = x + blk._tp_out(y)
    h = rms_norm(x, p["mlp_norm"])
    return x + blk.mlp(p, h), h_state, carry


# ---------------------------------------------------------------------------
# decode_step
# ---------------------------------------------------------------------------

@torch.inference_mode()
def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: DecodeCache) -> tuple[torch.Tensor, DecodeCache]:
    """tokens (B, 1) -> (logits (B, 1, padded_vocab) float32, the cache
    advanced by one token)."""
    cfg = model.cfg
    tokens = torch.as_tensor(tokens, device=model.device)
    x = constrain(model.lookup(tokens), "dp", None, None)
    ia = iss = irec = 0
    for blk in model.blocks:
        if blk.kind == "ssm":
            x, st, cv = _ssm_block_step(blk, x, cfg, cache.ssm_state[iss],
                                        cache.conv_carry[iss])
            cache.ssm_state[iss] = st
            cache.conv_carry[iss] = cv
            iss += 1
        elif blk.kind == "rec":
            x, hs, cv = _rec_block_step(blk, x, cfg, cache.rec_h[irec],
                                        cache.rec_conv[irec])
            cache.rec_h[irec] = hs
            cache.rec_conv[irec] = cv
            irec += 1
        else:
            kv = KVCache(k=cache.kv_k[ia], v=cache.kv_v[ia],
                         length=cache.length)
            x = _attn_block_step(blk, x, cfg, kv)
            ia += 1
    x = rms_norm(x, model.weight("final_norm"))
    return model.lm_logits(x), cache._replace(length=cache.length + 1)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill(model: Transformer, tokens: torch.Tensor, context: int, *,
            vision=None, keep=None) -> tuple[torch.Tensor, DecodeCache]:
    """Full forward over the prompt tokens (B, S) (after ``vision`` (B,
    n_vis, D) for vlm): (logits (B, n_vis + S, padded_vocab) float32, the
    populated cache).  Under tensor parallelism (a rank of
    ``serve.parallel.ShardedServer``) the stream runs in the training
    layout, the logits are this rank's block of the vocabulary, as the
    reference's prefill leaves them sharded over 'model', and
    ``keep(field, blk, t)`` gives what the rank keeps of each layer's
    cache tensor ``t``."""
    cfg = model.cfg
    _check_decoder(cfg)
    x, positions, seq = model.embed_inputs(tokens, vision=vision)
    x = constrain(x, "dp", None, None)
    cap = cache_capacity(cfg, context)
    got = {k: [] for k in DecodeCache._fields if k != "length"}

    def add(field, blk, t):
        got[field].append(t if keep is None else keep(field, blk, t))

    for blk in model.blocks:
        p = blk.params()
        if blk.kind == "ssm":
            y, carry, state = _ssm_mix(p, rms_norm(x, p["norm"]), cfg)
            x = x + y
            add("ssm_state", blk, state)
            add("conv_carry", blk, carry)
            continue
        h = rms_norm(x, p["attn_norm"])
        if blk.kind == "rec":
            y, carry, h_last = blk.recurrent(p, h, seq)
            add("rec_h", blk, h_last)
            add("rec_conv", blk, carry)
        else:
            # K and V from the attention's own projections (the reference
            # recomputes them; the values are the same)
            y, k, v = blk.attention(p, h, positions, seq)
            kv = attn.cache_of(k, v, cap, attn.cfg_dtype(cfg))
            add("kv_k", blk, kv.k)
            add("kv_v", blk, kv.v)
        x = x + y
        h = rms_norm(x, p["mlp_norm"])
        x = x + blk.mlp(p, h, seq)
    cache = DecodeCache(**{k: torch.stack(ts).contiguous()
                           for k, ts in got.items() if ts},
                        length=positions.shape[1])
    x = rms_norm(x, model.weight("final_norm"))
    return model.lm_logits(x, False, seq), cache
