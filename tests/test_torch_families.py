"""The port's MoE, SSM, hybrid, VLM and audio families, held against the
JAX package.

The same parameters (initialized by the reference in this process and
carried across with ``convert.transformer_params_from_reference``: the
reference seeds its leaves with ``hash(path)``, which Python salts per
process) and the same seeded inputs go through the reference's
``forward`` / ``prefill`` / ``decode_step`` / layer functions and the
port's, in float32 on the CPU.  Tolerances: 1e-4 between the packages
(float32 sums in another order; the RG-LRU scan's tree differs from
XLA's), 2e-3 for prefill plus decode against the full forward and 3e-3 for
the long ring-buffer decode (the reference tests' own,
``tests/test_serve.py``), and 1e-5 / 1e-4 for a scan against its
sequential oracle (``tests/test_models.py``'s).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba2 as ref_mamba2
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_params as ref_init_params
from repro.models.transformer import train_loss as ref_train_loss
from repro.serve import decode_step as ref_decode_step
from repro.serve import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.convert import (reference_layout,
                                 transformer_params_from_reference)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2, moe, rglru
from repro_torch.models.transformer import (Transformer, hybrid_grouping,
                                            init_params, layer_kinds,
                                            train_loss)
from repro_torch.serve import decode_step, init_decode_cache, prefill
from repro_torch.train import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)          # port against the reference
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)    # prefill + decode against forward
ARCHS = ["mixtral-8x7b", "grok-1-314b", "mamba2-370m", "recurrentgemma-2b",
         "internvl2-76b", "hubert-xlarge"]
DECODERS = [a for a in ARCHS if a != "hubert-xlarge"]
CACHE_LEAVES = ("kv_k", "kv_v", "ssm_state", "conv_carry", "rec_h",
                "rec_conv")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(cfg, params):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_params_from_reference(_np(params),
                                                            cfg))
    return model


@pytest.fixture(scope="module")
def models():
    """Per arch: (the reference's config and params, the port's model)."""
    out = {}
    for arch in ARCHS:
        ref_cfg = ref_get_config(arch, smoke=True)
        params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
        out[arch] = (ref_cfg, params, _port(get_config(arch, smoke=True),
                                            params))
    return out


def _inputs(cfg, b, s, seed=0):
    """numpy inputs of the family: frames + labels (audio), tokens +
    vision (vlm; s text tokens after the vision tokens) or tokens."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, s, cfg.frontend_dim)
                                     ).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.normal(size=(b, cfg.vision_tokens, cfg.d_model)
                                   ).astype(np.float32)
    return out


def _port_kw(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if k in ("frames", "vision")}


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the whole model: forward, prefill + decode, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    ref_cfg, params, model = models[arch]
    batch = _inputs(ref_cfg, 2, 16)
    want = np.asarray(ref_forward(params, ref_cfg, _ref_batch(batch)))
    toks = batch.get("tokens")
    got = model(None if toks is None else torch.from_numpy(toks),
                **_port_kw(batch)).numpy()
    n_vis = ref_cfg.vision_tokens if ref_cfg.family == "vlm" else 0
    assert got.shape == want.shape == (2, 16 + n_vis, ref_cfg.padded_vocab)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got[..., :ref_cfg.vocab_size]).all()
    if ref_cfg.padded_vocab != ref_cfg.vocab_size:
        assert (got[..., ref_cfg.vocab_size:] == -1e30).all()


# (tokens, prompt): mamba2's prompt spans two smoke chunks of 8 and a
# ragged tail; recurrentgemma decodes past its local window of 16
SERVE_CASES = {"mixtral-8x7b": (16, 12), "grok-1-314b": (16, 12),
               "mamba2-370m": (24, 19), "recurrentgemma-2b": (24, 10),
               "internvl2-76b": (16, 12)}


def _assert_cache(cache, ref_cache):
    for leaf in CACHE_LEAVES:
        got, want = getattr(cache, leaf), getattr(ref_cache, leaf)
        assert (got is None) == (want is None), leaf
        if got is not None:
            assert got.shape == want.shape, leaf
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=leaf, **TOL)
    assert cache.length == int(ref_cache.length)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference_and_forward(models, arch):
    ref_cfg, params, model = models[arch]
    S, P = SERVE_CASES[arch]
    batch = _inputs(ref_cfg, 2, S, seed=1)
    toks = batch["tokens"]
    vis = {k: v for k, v in batch.items() if k == "vision"}
    off = ref_cfg.vision_tokens if vis else 0
    full = model(torch.from_numpy(toks), **_port_kw(vis)).numpy()
    ref_lp, ref_cache = ref_prefill(
        params, ref_cfg, _ref_batch({"tokens": toks[:, :P], **vis}),
        context=S + off)
    lp, cache = prefill(model, torch.from_numpy(toks[:, :P]),
                        context=S + off, **_port_kw(vis))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), **TOL)
    np.testing.assert_allclose(lp.numpy(), full[:, :off + P], **SERVE_TOL)
    _assert_cache(cache, ref_cache)
    for t in range(P, S):
        ref_lg, ref_cache = ref_decode_step(
            params, ref_cfg, jnp.asarray(toks[:, t:t + 1]), ref_cache)
        lg, cache = decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, off + t],
                                   **SERVE_TOL)
    _assert_cache(cache, ref_cache)
    assert cache.length == S + off


def test_sliding_window_ring_cache(models):
    """Decode far beyond the window: the ring buffer stays exact."""
    ref_cfg, params, model = models["mixtral-8x7b"]     # window 16
    toks = _inputs(ref_cfg, 1, 40, seed=2)["tokens"]
    full = model(torch.from_numpy(toks)).numpy()
    want = np.asarray(ref_forward(params, ref_cfg,
                                  {"tokens": jnp.asarray(toks)}))
    np.testing.assert_allclose(full, want, **TOL)
    _, cache = prefill(model, torch.from_numpy(toks[:, :8]), context=40)
    for t in range(8, 40):
        lg, cache = decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                cache)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t], rtol=3e-3,
                                   atol=3e-3)
    assert cache.kv_k.shape[2] == ref_cfg.sliding_window   # O(window)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(models, arch):
    ref_cfg, params, model = models[arch]
    batch = _inputs(ref_cfg, 2, 12, seed=3)
    want = float(ref_train_loss(params, ref_cfg, _ref_batch(batch)))
    with torch.no_grad():
        got = float(train_loss(model, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the decode cache
# ---------------------------------------------------------------------------

def test_decode_cache_encoder_rejected(models):
    cfg = get_config("hubert-xlarge", smoke=True)
    with pytest.raises(ValueError, match="encoder-only"):
        init_decode_cache(cfg, 2, 64, device="cpu")
    model = models["hubert-xlarge"][2]
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(model, None, context=8)


def test_cache_is_constant_memory_for_ssm():
    cfg = get_config("mamba2-370m", smoke=True)
    c1 = init_decode_cache(cfg, 2, 128, device="cpu")
    c2 = init_decode_cache(cfg, 2, 1 << 19, device="cpu")
    assert c1.ssm_state.shape == c2.ssm_state.shape   # O(1) in context
    assert c1.ssm_state.dtype == torch.float32 and c1.kv_k is None


@pytest.mark.parametrize("arch", DECODERS)
def test_init_decode_cache_matches_reference_layout(arch):
    from repro.serve.engine import init_decode_cache as ref_init_cache
    ref = ref_init_cache(ref_get_config(arch, smoke=True), 3, 64)
    got = init_decode_cache(get_config(arch, smoke=True), 3, 64,
                            device="cpu")
    for leaf in CACHE_LEAVES:
        want = getattr(ref, leaf)
        have = getattr(got, leaf)
        assert (have is None) == (want is None), leaf
        if want is not None:
            assert tuple(have.shape) == want.shape, leaf
            assert str(have.dtype).split(".")[-1] == str(want.dtype), leaf
            assert not have.any()
    assert got.length == 0


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_layer(seed=0, **kw):
    """One MoE layer of mixtral-smoke (with ``kw`` overrides) from seeded
    numpy weights (the reference's own init salts its seeds per
    process): (the reference's config and params, the port's)."""
    ref_cfg = ref_get_config("mixtral-8x7b", smoke=True).with_(**kw)
    cfg = get_config("mixtral-8x7b", smoke=True).with_(**kw)
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    pn = {"w_router": rng.normal(size=(d, e)) * 0.1,
          "w_gate": rng.normal(size=(e, d, f)) * 0.02,
          "w_up": rng.normal(size=(e, d, f)) * 0.02,
          "w_down": rng.normal(size=(e, f, d)) * 0.02}
    pn = {k: v.astype(np.float32) for k, v in pn.items()}
    return (ref_cfg, {k: jnp.asarray(v) for k, v in pn.items()},
            {k: torch.from_numpy(v) for k, v in pn.items()}, cfg)


def test_moe_sorted_matches_dense(rng):
    ref_cfg, lp, p, cfg = _moe_layer()
    x = rng.normal(size=(3, 16, cfg.d_model)).astype(np.float32)
    got = moe.moe_sorted(p, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(
        got, moe.moe_dense(p, torch.from_numpy(x), cfg).numpy(),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got, np.asarray(ref_moe.moe_sorted(lp, jnp.asarray(x), ref_cfg)),
        **TOL)
    np.testing.assert_allclose(
        moe.moe_dense(p, torch.from_numpy(x), cfg).numpy(),
        np.asarray(ref_moe.moe_dense(lp, jnp.asarray(x), ref_cfg)), **TOL)


def test_moe_capacity_drops_bounded(rng):
    _, _, p, cfg = _moe_layer(capacity_factor=1.0)
    x = torch.from_numpy(rng.normal(size=(3, 16, cfg.d_model)
                                    ).astype(np.float32))
    y = moe.moe_sorted(p, x, cfg)
    assert torch.isfinite(y).all()
    _, _, inv, a_slot, _, cap = moe.route(p, x, cfg)
    e = cfg.n_experts
    assert (a_slot == e * cap).any(), "capacity 1.0 drops here"
    # in each row a kept assignment has a slot of its own, and the slot
    # names the token whose assignment points at it
    for row in range(3):
        kept = a_slot[row][a_slot[row] < e * cap].tolist()
        assert len(set(kept)) == len(kept)
        for slot in kept:
            tok = int(inv[row, slot])
            assert slot in a_slot[row, tok].tolist()


def _drops_oracle(idx: np.ndarray, e: int, cap: int) -> np.ndarray:
    """Which assignments (B, S, k) overflow: an assignment's place in its
    expert's queue is the count of earlier (token, choice) assignments to
    that expert."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    drop = np.zeros(flat.shape, bool)
    for r in range(b):
        seen = np.zeros(e, int)
        for j, ex in enumerate(flat[r]):
            drop[r, j] = seen[ex] >= cap
            seen[ex] += 1
    return drop.reshape(idx.shape)


def test_moe_sorted_drops_match_reference_at_full_capacity_factor(rng):
    """At the full config's capacity factor 1.25 assignments drop: the
    port routes like the reference (the same top-k), drops the same
    assignments, and its output agrees."""
    full_cf = get_config("mixtral-8x7b").capacity_factor
    assert full_cf == 1.25
    ref_cfg, lp, p, cfg = _moe_layer(capacity_factor=full_cf)
    x = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    _, idx, _, a_slot, _, cap = moe.route(p, torch.from_numpy(x), cfg)
    ref_logits = ref_moe.router_probs(lp, jnp.asarray(x).reshape(-1,
                                      cfg.d_model), cfg.n_experts)
    _, ref_idx = ref_moe._top_k_gates(ref_logits, cfg.experts_per_token)
    ref_idx = np.asarray(ref_idx).reshape(idx.shape)
    assert (idx.numpy() == ref_idx).all(), "routing differs"
    dropped = (a_slot == cfg.n_experts * cap).numpy()
    assert dropped.any(), "capacity 1.25 drops assignments here"
    assert (dropped == _drops_oracle(ref_idx, cfg.n_experts, cap)).all()
    np.testing.assert_allclose(
        moe.moe_sorted(p, torch.from_numpy(x), cfg).numpy(),
        np.asarray(ref_moe.moe_sorted(lp, jnp.asarray(x), ref_cfg)), **TOL)


def test_moe_aux_loss_positive(rng):
    ref_cfg, lp, p, cfg = _moe_layer()
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    aux = float(moe.aux_load_balance_loss(p, torch.from_numpy(x), cfg))
    assert aux >= 1.0 - 1e-3   # >= 1 by Cauchy-Schwarz, == 1 when balanced
    np.testing.assert_allclose(
        aux, float(ref_moe.aux_load_balance_loss(lp, jnp.asarray(x),
                                                 ref_cfg)), **TOL)


def test_top_k_breaks_ties_toward_the_lower_expert():
    logits = np.array([[0.5, 2.0, 2.0, 1.0, 2.0],
                       [1.0, 1.0, 1.0, 1.0, 1.0],
                       [3.0, 0.0, 3.0, 0.0, -1.0]], np.float32)
    gates, idx = moe._top_k_gates(torch.from_numpy(logits), 2)
    ref_gates, ref_idx = ref_moe._top_k_gates(jnp.asarray(logits), 2)
    assert (idx.numpy() == np.asarray(ref_idx)).all()
    np.testing.assert_allclose(gates.numpy(), np.asarray(ref_gates), **TOL)


# ---------------------------------------------------------------------------
# SSD and RG-LRU
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, B, S, H, P, N):
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.5 + 0.05).astype(np.float32)
    a_log = (rng.normal(size=(H,)) * 0.3).astype(np.float32)
    bm = rng.normal(size=(B, S, N)).astype(np.float32)
    cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, a_log, bm, cm


@pytest.mark.parametrize("shape", [(2, 24, 3, 4, 8), (1, 19, 2, 4, 8)],
                         ids=["whole_chunks", "ragged_tail"])
def test_ssd_chunked_vs_reference(rng, shape):
    """Chunked SSD against the sequential oracle (the ragged case pads the
    tail), and against the reference's chunked scan."""
    ins = _ssd_inputs(rng, *shape)
    t = [torch.from_numpy(a) for a in ins]
    y_seq, st_seq = mamba2.ssd_reference(*t)
    y, st = mamba2.ssd_chunked(*t, 8)
    assert y.shape == shape[:4]
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st_seq.numpy(), **TOL)
    ref_y, ref_st = ref_mamba2.ssd_chunked(*map(jnp.asarray, ins), 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(ref_st), **TOL)


def test_ssd_chunked_carries_init_state(rng):
    """Two halves chained through the state equal the whole sequence."""
    ins = [torch.from_numpy(a) for a in _ssd_inputs(rng, 2, 21, 3, 4, 8)]
    y, st = mamba2.ssd_chunked(*ins, 8)
    first = [a[:, :13] if a.ndim > 1 else a for a in ins]
    second = [a[:, 13:] if a.ndim > 1 else a for a in ins]
    y1, st1 = mamba2.ssd_chunked(*first, 8)
    y2, st2 = mamba2.ssd_chunked(*second, 8, init_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **TOL)
    np.testing.assert_allclose(st2.numpy(), st.numpy(), **TOL)


def _lru_params(rng, D):
    return {"w_a": rng.normal(size=(D, D)) * 0.3,
            "b_a": rng.normal(size=(D,)),
            "w_x": rng.normal(size=(D, D)) * 0.3,
            "b_x": rng.normal(size=(D,)),
            "lam": rng.normal(size=(D,)) + 2.0}


@pytest.mark.parametrize("with_init_h", [False, True])
def test_rglru_scan_vs_reference(rng, with_init_h):
    B, S, D = 2, 17, 8
    pn = {k: v.astype(np.float32) for k, v in _lru_params(rng, D).items()}
    p = {k: torch.from_numpy(v) for k, v in pn.items()}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32) if with_init_h else None
    tx = torch.from_numpy(x)
    h, h_last = rglru.rglru_scan(p, tx, init_h=None if h0 is None
                                 else torch.from_numpy(h0))
    # the sequential oracle, from h0
    hs, prev = [], (torch.zeros(B, D) if h0 is None
                    else torch.from_numpy(h0))
    for t in range(S):
        prev = rglru.rglru_step(p, tx[:, t], prev)
        hs.append(prev)
    h_seq = torch.stack(hs, 1)
    np.testing.assert_allclose(h.numpy(), h_seq.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), h_seq[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    if h0 is None:
        np.testing.assert_allclose(
            rglru.rglru_reference(p, tx).numpy(), h_seq.numpy(), rtol=1e-6,
            atol=1e-6)
    pj = {k: jnp.asarray(v) for k, v in pn.items()}
    ref_h, ref_last = ref_rglru.rglru_scan(
        pj, jnp.asarray(x), init_h=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(ref_last),
                               rtol=1e-5, atol=1e-5)
    # decode continuation
    hstep = rglru.rglru_step(p, tx[:, 10], h_seq[:, 9])
    np.testing.assert_allclose(hstep.numpy(), h_seq[:, 10].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [1, 4])
def test_temporal_conv_with_carry_matches_reference(rng, width):
    B, S, D = 2, 7, 5
    w = rng.normal(size=(width, D)).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    carry = rng.normal(size=(B, width - 1, D)).astype(np.float32)
    for c in (None, carry):
        out, new = rglru.temporal_conv(
            {"conv_w": torch.from_numpy(w)}, torch.from_numpy(x), width,
            None if c is None else torch.from_numpy(c))
        ref_out, ref_new = ref_rglru.temporal_conv(
            {"conv_w": jnp.asarray(w)}, jnp.asarray(x), width,
            None if c is None else jnp.asarray(c))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
        np.testing.assert_array_equal(new.numpy(), np.asarray(ref_new))
    # chained one token at a time through the carry == the whole sequence
    cv, outs = torch.from_numpy(carry), []
    for t in range(S):
        o, cv = rglru.temporal_conv({"conv_w": torch.from_numpy(w)},
                                    torch.from_numpy(x[:, t:t + 1]), width,
                                    cv)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), out.numpy(),
                               **TOL)


# ---------------------------------------------------------------------------
# weights carried across, the family gates, the launchers
# ---------------------------------------------------------------------------

def test_convert_hybrid_groups_and_tail(models):
    ref_cfg, params, model = models["recurrentgemma-2b"]
    cfg = model.cfg.with_(n_layers=5)       # one group of 3 + a tail of 2
    assert hybrid_grouping(cfg) == (1, 2) and reference_layout(cfg) == \
        "groups"
    tree = _np(ref_init_params(ref_cfg.with_(n_layers=5),
                               jax.random.PRNGKey(1)))
    assert len(tree["groups"]) == 3 and len(tree["tail"]) == 2
    state = transformer_params_from_reference(tree, cfg)
    kinds = layer_kinds(cfg)
    assert kinds == ["rec", "rec", "dense", "rec", "rec"]
    np.testing.assert_array_equal(state["blocks.1.w_a"].numpy(),
                                  tree["groups"][1]["w_a"][0])
    np.testing.assert_array_equal(state["blocks.2.wq"].numpy(),
                                  tree["groups"][2]["wq"][0])
    np.testing.assert_array_equal(state["blocks.4.lam"].numpy(),
                                  tree["tail"][1]["lam"])
    assert (state["blocks.3.lam"] == 4.0).all()
    Transformer(cfg, device="cpu").load_state_dict(state)   # strict
    tree["tail"][1]["w_x"] = tree["tail"][1]["w_x"][:, :-1]
    with pytest.raises(ValueError, match="tail/1/w_x"):
        transformer_params_from_reference(tree, cfg)
    tree["groups"][0]["w_a"] = tree["groups"][0]["w_a"][:, :, :-1]
    with pytest.raises(ValueError, match="groups/0/w_a"):
        transformer_params_from_reference(tree, cfg)
    del tree["tail"]
    with pytest.raises(ValueError, match="expected"):
        transformer_params_from_reference(tree, cfg)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "hubert-xlarge"])
def test_convert_refuses_wrong_leaves(models, arch):
    ref_cfg, params, model = models[arch]
    tree = _np(params)
    key = "w_gate" if arch == "mixtral-8x7b" else "w_in"
    tree["blocks"][key] = tree["blocks"][key][..., :-1]
    with pytest.raises(ValueError, match=f"blocks/{key}"):
        transformer_params_from_reference(tree, model.cfg)
    del tree["blocks"][key]
    with pytest.raises(ValueError, match="blocks: expected"):
        transformer_params_from_reference(tree, model.cfg)


def test_unrolled_layers_convert(models):
    """A config without layer scans keeps the reference's unrolled
    ``layers`` list."""
    ref_cfg, _, model = models["mamba2-370m"]
    cfg = model.cfg.with_(scan_layers=False)
    tree = _np(ref_init_params(ref_cfg.with_(scan_layers=False),
                               jax.random.PRNGKey(2)))
    assert reference_layout(cfg) == "layers" and len(tree["layers"]) == 2
    state = transformer_params_from_reference(tree, cfg)
    np.testing.assert_array_equal(state["blocks.1.in_proj"].numpy(),
                                  tree["layers"][1]["in_proj"])


def test_init_params_kinds_and_lam():
    cfg = get_config("recurrentgemma-2b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [b.kind for b in model.blocks] == ["rec", "rec", "dense"]
    assert [b.window for b in model.blocks][-1] == cfg.local_window
    assert (model.blocks[0].lam == 4.0).all()
    assert not hasattr(model, "lm_head")            # tied
    audio = init_params(get_config("hubert-xlarge", smoke=True),
                        torch.Generator().manual_seed(0), "cpu")
    assert {"frontend_proj", "head"} <= set(audio.state_dict())
    assert "embed" not in audio.state_dict()


@pytest.mark.parametrize("arch,inputs", [
    ("hubert-xlarge", {"tokens"}), ("internvl2-76b", {"tokens"}),
    ("mixtral-8x7b", {"tokens", "vision"})])
def test_forward_refuses_the_wrong_inputs(models, arch, inputs):
    cfg, _, model = models[arch]
    batch = _inputs(cfg, 1, 4)
    batch.setdefault("tokens", np.zeros((1, 4), np.int32))
    batch.setdefault("vision", np.zeros((1, 2, cfg.d_model), np.float32))
    kw = {k: torch.from_numpy(batch[k]) for k in inputs if k != "tokens"}
    with pytest.raises(ValueError, match="takes"):
        model(torch.from_numpy(batch["tokens"]), **kw)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_launch_serve_finishes_every_request(arch):
    cfg = get_config(arch, smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    r = launch_serve.serve(model, launch_serve.make_prompts(cfg, 5, 6, 0),
                           batch_size=2, max_new=3, context=16)
    assert sorted(q.uid for q in r["finished"]) == list(range(5))
    assert all(len(q.generated) == 3 and
               all(0 <= t < cfg.vocab_size for t in q.generated)
               for q in r["finished"])
    assert r["n_steps"] == len(r["decode_s"]) == 15


@pytest.mark.parametrize("arch,why", [("hubert-xlarge", "encoder-only"),
                                      ("internvl2-76b", "vision")])
def test_launch_serve_refuses(arch, why):
    with pytest.raises(SystemExit, match=why):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_launch_serve_runs_mixtral_as_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x7b", "--smoke", "--device", "cpu", "--requests", "2",
         "--max-new", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "served 2 requests, 4 decode steps" in proc.stdout


@pytest.mark.parametrize("arch", ["internvl2-76b", "hubert-xlarge"])
def test_training_other_families_is_refused(arch, tmp_path, capsys):
    """The loop's token pipeline cannot feed the vlm's patch embeddings
    or the audio frames: the Trainer and the launcher refuse both and
    point at make_train_step (the other families train:
    ``test_torch_train_families.py``)."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(ValueError, match="TokenPipeline.*make_train_step"):
        Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path)), "cpu", 2, 8)
    with pytest.raises(SystemExit):
        launch_train.build(["--arch", arch, "--smoke", "--device", "cpu",
                            "--checkpoint-dir", str(tmp_path)])
    assert "TokenPipeline makes tokens only" in capsys.readouterr().err


def test_logic_mlp_is_refused_outside_the_dense_family():
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              logic_mlp=True)
    with pytest.raises(ValueError, match="logic_mlp"):
        Transformer(cfg, device="cpu")
