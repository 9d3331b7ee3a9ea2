"""The port's dense LM serving path, held against the JAX package.

The same parameters (initialized by the reference in this process and
carried across with ``convert.transformer_params_from_reference``: the
reference seeds its leaves with ``hash(path)``, which Python salts per
process, so they are never saved and reloaded) and the same seeded tokens
go through the reference's ``forward`` / ``prefill`` / ``decode_step`` and
the port's, in float32 on the CPU.  Tolerances: 1e-4 between the packages
(float32 sums in another order), 2e-3 for prefill plus decode against the
full forward (the reference test's own, ``tests/test_serve.py``).
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
from repro.models import layers as ref_layers
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_params as ref_init_params
from repro.serve import decode_step as ref_decode_step
from repro.serve import prefill as ref_prefill
from repro_torch.configs import ARCH_IDS, all_cells, get_config
from repro_torch.convert import transformer_params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers
from repro_torch.models.attention import init_cache
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serve import (Request, RequestBatcher, decode_step,
                               init_decode_cache, prefill)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)          # port against the reference
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)    # prefill + decode against forward
# (arch, overrides of its smoke config): qwen3 (GQA, qk-norm), minicpm
# (MHA, tied embeddings), a vocabulary that pads (the -1e30 columns) and a
# sliding window shorter than the prompt (the ring cache)
CASES = {"qwen3-8b": ("qwen3-8b", {}),
         "minicpm-2b": ("minicpm-2b", {}),
         "qwen3-8b-vocab500": ("qwen3-8b", {"vocab_size": 500}),
         "qwen3-8b-window8": ("qwen3-8b", {"sliding_window": 8})}


@pytest.fixture(scope="module")
def models():
    """Per case: (the reference's config and params, the port's model)."""
    out = {}
    for case, (arch, kw) in CASES.items():
        ref_cfg = ref_get_config(arch, smoke=True).with_(**kw)
        cfg = get_config(arch, smoke=True).with_(**kw)
        params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(transformer_params_from_reference(
            jax.tree.map(np.asarray, params), cfg))
        out[case] = (ref_cfg, params, model)
    return out


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_reference(models, case):
    ref_cfg, params, model = models[case]
    toks = _tokens(ref_cfg, 2, 16)
    want = np.asarray(ref_forward(params, ref_cfg,
                                  {"tokens": jnp.asarray(toks)}))
    got = model(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, 16, ref_cfg.padded_vocab)
    np.testing.assert_allclose(got, want, **TOL)
    if ref_cfg.padded_vocab != ref_cfg.vocab_size:
        assert (got[..., ref_cfg.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_reference_and_forward(models, case):
    ref_cfg, params, model = models[case]
    B, S = 2, 24 if "window" in case else 16
    P = S // 2 if "window" in case else S - 4
    toks = _tokens(ref_cfg, B, S, seed=1)
    full = model(torch.from_numpy(toks)).numpy()
    ref_lp, ref_cache = ref_prefill(params, ref_cfg,
                                    {"tokens": jnp.asarray(toks[:, :P])},
                                    context=S)
    lp, cache = prefill(model, torch.from_numpy(toks[:, :P]), context=S)
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), **TOL)
    np.testing.assert_allclose(lp.numpy(), full[:, :P], **SERVE_TOL)
    np.testing.assert_allclose(cache.kv_k.numpy(),
                               np.asarray(ref_cache.kv_k), **TOL)
    for t in range(P, S):
        ref_lg, ref_cache = ref_decode_step(
            params, ref_cfg, jnp.asarray(toks[:, t:t + 1]), ref_cache)
        lg, cache = decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), **TOL)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t],
                                   **SERVE_TOL)
    assert cache.length == int(ref_cache.length) == S
    np.testing.assert_allclose(cache.kv_v.numpy(),
                               np.asarray(ref_cache.kv_v), **TOL)
    if ref_cfg.sliding_window:          # the cache stayed O(window)
        assert cache.kv_k.shape[2] == ref_cfg.sliding_window


def test_init_decode_cache_shapes_and_device():
    cfg = get_config("qwen3-8b", smoke=True).with_(sliding_window=8)
    c = init_decode_cache(cfg, 3, 64, device="cpu")
    assert c.kv_k.shape == (cfg.n_layers, 3, 8, cfg.n_kv_heads,
                            cfg.resolved_head_dim)
    assert c.length == 0 and c.kv_v.dtype == torch.float32
    kv = init_cache(3, 8, cfg.n_kv_heads, cfg.resolved_head_dim,
                    torch.bfloat16, device="cpu")
    assert kv.k.shape == c.kv_k.shape[1:] and kv.length == 0
    assert kv.v.dtype == torch.bfloat16 and not kv.v.any()


# ---------------------------------------------------------------------------
# layers, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rms_norm", "apply_rope", "swiglu",
                                "gelu_mlp", "softmax_xent",
                                "softmax_xent_masked"])
def test_layer_matches_reference(fn):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * 0.3
         for s in ((16, 24), (16, 24), (24, 16))]
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    labels = rng.integers(0, 16, (2, 6, 4))
    mask = (rng.random((2, 6, 4)) < 0.7).astype(np.float32)
    t = torch.from_numpy
    if fn == "rms_norm":
        got = layers.rms_norm(t(x), t(w[2][0]))
        want = ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w[2][0]))
    elif fn == "apply_rope":
        got = layers.apply_rope(t(x), t(pos.copy()), 1e4)
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    elif fn in ("swiglu", "gelu_mlp"):
        ws = w if fn == "swiglu" else (w[0], w[2])
        got = getattr(layers, fn)(t(x), *map(t, ws))
        want = getattr(ref_layers, fn)(jnp.asarray(x), *map(jnp.asarray, ws))
    else:
        m = fn.endswith("masked")
        got = layers.softmax_xent(t(x), t(labels), t(mask) if m else None)
        want = ref_layers.softmax_xent(jnp.asarray(x), jnp.asarray(labels),
                                       jnp.asarray(mask) if m else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# configs, weights carried across, the launcher
# ---------------------------------------------------------------------------

def test_configs_equal_the_reference():
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke)) == \
                dataclasses.asdict(ref_get_config(arch, smoke)), arch
    assert len(list(all_cells())) == 40


def test_reference_params_must_match_the_spec():
    cfg = get_config("qwen3-8b", smoke=True)
    state = {k: v.numpy() for k, v in
             init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu").state_dict().items()}
    tree = {k: state[k] for k in ("embed", "lm_head", "final_norm")}
    tree["blocks"] = {k.split(".", 2)[2]: np.stack(
        [state[f"blocks.{i}.{k.split('.', 2)[2]}"]
         for i in range(cfg.n_layers)])
        for k in state if k.startswith("blocks.0.")}
    back = transformer_params_from_reference(tree, cfg)
    assert set(back) == set(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    tree["blocks"]["wq"] = tree["blocks"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="blocks/wq"):
        transformer_params_from_reference(tree, cfg)
    del tree["lm_head"]
    with pytest.raises(ValueError, match="expected"):
        transformer_params_from_reference(tree, cfg)


def test_init_params_is_seeded_and_scaled():
    cfg = get_config("qwen3-8b", smoke=True)
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert abs(float(a.blocks[0].wq.std()) - 0.02) < 2e-3
    assert torch.equal(a.blocks[1].attn_norm, torch.ones(cfg.d_model))


def test_launch_serve_finishes_every_request():
    cfg = get_config("qwen3-8b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    r = launch_serve.serve(model, launch_serve.make_prompts(cfg, 5, 6, 0),
                           batch_size=2, max_new=3, context=16)
    assert sorted(q.uid for q in r["finished"]) == list(range(5))
    assert all(len(q.generated) == 3 and
               all(0 <= t < cfg.vocab_size for t in q.generated)
               for q in r["finished"])
    assert r["n_steps"] == len(r["decode_s"]) == 15
    assert len(r["prefill_s"]) == 5


def test_launch_serve_runs_as_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_lm", "--device",
         "cpu", "--requests", "2", "--max-new", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "served 2 requests, 4 decode steps" in proc.stdout


# ---------------------------------------------------------------------------
# the continuous batcher (counterparts of tests/test_serve.py's)
# ---------------------------------------------------------------------------

def test_batcher_continuous():
    b = RequestBatcher(batch_size=2)
    for uid in range(5):
        b.submit(Request(uid=uid, prompt=np.array([1, 2]), max_new_tokens=2))
    served = 0
    rounds = 0
    while not b.idle and rounds < 50:
        b.admit()
        toks = np.full((2,), 7, np.int64)
        before = len(b.finished)
        b.record_tokens(toks)
        served += len(b.finished) - before
        rounds += 1
    assert served == 5
    assert all(len(r.generated) == 2 for r in b.finished)


def test_batcher_slot_recycling():
    b = RequestBatcher(batch_size=1)
    b.submit(Request(uid=0, prompt=np.array([1]), max_new_tokens=1))
    b.submit(Request(uid=1, prompt=np.array([1]), max_new_tokens=1))
    b.admit()
    assert b.slots[0].uid == 0
    b.record_tokens(np.array([5]))
    assert b.slots[0] is None
    b.admit()
    assert b.slots[0].uid == 1
