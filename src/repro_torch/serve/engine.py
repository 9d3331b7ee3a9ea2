"""Serving: the decode cache, prefill and single-token decode.

Port of ``src/repro/serve/engine.py`` for the dense family (the others
raise ``NotImplementedError``, ``models/transformer.check_family``).  The
cache is the KV pair stacked over layers, (L, B, C, Hk, hd) each, with
C = min(context, window) for sliding-window configs (a ring buffer, see
``models/attention.py``).  ``prefill`` runs the full forward over the
prompt once and fills every layer's cache; ``decode_step`` advances one
token.  The reference scans over stacked layer parameters; here both walk
the model's blocks in a Python loop, and a decode step writes each layer's
slot of the cache in place (the returned cache holds the same tensors with
``length + 1``).  Both run under ``torch.inference_mode()``: the model's
forward records autograd where grad is enabled (training), and serving
enters inference mode itself.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.logic_dsp.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (Block, Transformer, _cdtype,
                                            check_family)


class DecodeCache(NamedTuple):
    kv_k: torch.Tensor        # (L, B, C, Hk, hd)
    kv_v: torch.Tensor
    length: int               # tokens so far


def cache_capacity(cfg: ModelConfig, context: int) -> int:
    if cfg.sliding_window:
        return min(context, cfg.sliding_window)
    return context


def init_decode_cache(cfg: ModelConfig, batch: int, context: int,
                      device=None) -> DecodeCache:
    """An empty cache on ``device`` (CUDA unless ``"cpu"``; the model's
    device for :func:`decode_step`)."""
    check_family(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_capacity(cfg, context),
             cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = _cdtype(cfg)
    return DecodeCache(kv_k=torch.zeros(shape, dtype=dt, device=device),
                       kv_v=torch.zeros(shape, dtype=dt, device=device),
                       length=0)


def _attn_block_step(blk: Block, x, cfg, kv: KVCache, window: int):
    """One block on one token; the layer's cache slot is written in
    place."""
    p = blk.params()
    h = rms_norm(x, p["attn_norm"])
    h, _ = attn.attention_decode(p, h, cfg, kv, window=window)
    x = x + h
    h = rms_norm(x, p["mlp_norm"])
    return x + blk.ffn(p, h)


@torch.inference_mode()
def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: DecodeCache) -> tuple[torch.Tensor, DecodeCache]:
    """tokens (B, 1) -> (logits (B, 1, padded_vocab) float32, the cache
    advanced by one token)."""
    cfg = model.cfg
    tokens = torch.as_tensor(tokens, device=model.device)
    x = model.embed.to(_cdtype(cfg))[tokens]
    for i, blk in enumerate(model.blocks):
        kv = KVCache(k=cache.kv_k[i], v=cache.kv_v[i], length=cache.length)
        x = _attn_block_step(blk, x, cfg, kv, model.window)
    x = rms_norm(x, model.final_norm)
    return model.lm_logits(x), cache._replace(length=cache.length + 1)


@torch.inference_mode()
def prefill(model: Transformer, tokens: torch.Tensor, context: int
            ) -> tuple[torch.Tensor, DecodeCache]:
    """Full forward over the prompt tokens (B, S): (logits (B, S,
    padded_vocab) float32, the populated cache)."""
    cfg = model.cfg
    x, positions = model.embed_inputs(tokens)
    cap = cache_capacity(cfg, context)
    ks, vs = [], []
    for blk in model.blocks:
        p = blk.params()
        h = rms_norm(x, p["attn_norm"])
        h, kv = attn.prefill_cache(p, h, cfg, cap, positions=positions,
                                   window=model.window)
        x = x + h
        h = rms_norm(x, p["mlp_norm"])
        x = x + blk.ffn(p, h)
        ks.append(kv.k)
        vs.append(kv.v)
    cache = DecodeCache(kv_k=torch.stack(ks), kv_v=torch.stack(vs),
                        length=x.shape[1])
    x = rms_norm(x, model.final_norm)
    return model.lm_logits(x), cache
