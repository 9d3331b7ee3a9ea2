"""Training the MoE, SSM, hybrid, VLM and audio families: the port's
train step held against the reference's jitted step
(``jax.jit(make_train_step(cfg, tc))``, no mesh) on the CPU, the int8
round trip over the hybrid's leaf layout, the ``Trainer`` loop and the
launcher, and remat.

Step parity.  Both sides start from the reference's parameters and AdamW
state after one reference step (non-zero moments), carried across in this
process with ``convert.transformer_params_from_reference`` and
``convert.adamw_state_from_reference`` (the reference seeds its leaves
with ``hash(path)``, salted per process).  Then two steps on the same
seeded batches: ``tokens`` (4 x 32) for mixtral-8x7b, grok-1-314b,
mamba2-370m and recurrentgemma-2b (its smoke config's 3 layers, one
group, and 5 layers, one group and a 2-layer tail); ``tokens`` (4 x 24)
after 8 stub patch embeddings ``vision`` for internvl2-76b; ``frames``
(4 x 32 x 16) and ``labels`` for hubert-xlarge; and mixtral at its full
config's capacity factor 1.25, where assignments drop.  Each with
``grad_accum`` 1 and the int8 gradient round trip off, and with 2
micro-batches and the round trip on; mixtral at 1.25 and recurrentgemma
at 5 layers (the dispatch with drops, the hybrid's leaf layout) also
with the two other pairings (the file's time).
After each step ``loss``, ``grad_norm``, ``lr``, every parameter and both
moments are compared in float32, with ``test_torch_train_step.py``'s
tolerances:
  * ``loss``, ``grad_norm``: rtol 1e-5; ``lr``: rtol 1e-6;
  * parameters: atol 1e-4 = 0.1 lr (Adam moves an element by about lr
    whatever its gradient's size, so a gradient that cancels to near
    zero turns float32 noise into a visible share of lr);
  * moments: rtol 1e-3, atol 1e-6 (``mu``) and 1e-9 (``nu``);
  * with the int8 round trip at most 1e-3 of the elements outside these
    (an element whose float32 noise straddles a rounding midpoint lands
    on the neighbouring int8 level).
With ``moment_dtype="bfloat16"`` on both sides (internvl2 and grok-1's
full configs keep their moments so) the moments are compared at rtol
2**-7, one bfloat16 step (float32 noise that straddles a rounding
midpoint of the 16-bit moment moves it a whole step), and at most 1e-3 of
the elements may fall outside, as with int8.

The int8 layout test is bit-exact: the port's ``int8_round_trip`` equals
the reference's ``jax.tree.map`` of ``compress_int8`` then
``decompress_int8`` over its own tree (``groups[j]/{name}`` stacks and
the ``tail`` layers apart), leaf for leaf, eagerly (XLA's jitted
``amax / 127`` is a multiplication by the reciprocal).
"""
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.transformer import init_params as ref_init_params
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import compression as ref_comp
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_reference,
                                 reference_layout,
                                 transformer_params_from_reference)
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import (Transformer, hybrid_grouping,
                                            init_params, train_loss)
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, Trainer, make_train_step
from repro_torch.train.trainer import int8_round_trip, layer_stacks

ROOT = Path(__file__).resolve().parents[1]
P_TOL = dict(rtol=0.0, atol=1e-4)
MU_TOL = dict(rtol=1e-3, atol=1e-6)
NU_TOL = dict(rtol=1e-3, atol=1e-9)
BF16_MOMENT_RTOL = 2.0 ** -7
OUTLIERS = 1e-3
BATCH, SEQ, VIS_TEXT = 4, 32, 24
# (arch, config overrides on both sides)
CASES = {
    "mixtral-8x7b": ("mixtral-8x7b", {}),
    "mixtral-8x7b-cf1.25": ("mixtral-8x7b", {"capacity_factor": 1.25}),
    "grok-1-314b": ("grok-1-314b", {}),
    "mamba2-370m": ("mamba2-370m", {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}),
    "recurrentgemma-2b-5": ("recurrentgemma-2b", {"n_layers": 5}),
    "internvl2-76b": ("internvl2-76b", {}),
    "hubert-xlarge": ("hubert-xlarge", {}),
}
VARIANTS = [(1, False), (2, True)]
ALL_VARIANTS = [(1, False), (2, False), (1, True), (2, True)]
STEP_CASES = [(c, *v) for c in sorted(CASES) for v in (
    ALL_VARIANTS if c in ("mixtral-8x7b-cf1.25", "recurrentgemma-2b-5")
    else VARIANTS)]


@pytest.fixture(autouse=True)
def restore_signal_handlers():
    """``Trainer`` installs a PreemptionGuard on SIGTERM and SIGINT."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _configs(case: str):
    arch, over = CASES[case]
    return (dataclasses.replace(ref_get_config(arch, smoke=True), **over),
            get_config(arch, smoke=True).with_(**over))


def _batch(cfg, i: int) -> dict:
    """Batch ``i`` of the family's inputs, as numpy."""
    if cfg.family == "audio":
        rng = np.random.default_rng(i)
        return {"frames": rng.normal(size=(BATCH, SEQ, cfg.frontend_dim)
                                     ).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                                       dtype=np.int32)}
    seq = VIS_TEXT if cfg.family == "vlm" else SEQ
    out = TokenPipeline(cfg.vocab_size, BATCH, seq, seed=0).batch(i)
    if cfg.family == "vlm":
        out["vision"] = np.random.default_rng(i).normal(
            size=(BATCH, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _outside(got: torch.Tensor, want: torch.Tensor, tol: dict) -> int:
    return int((~torch.isclose(got.float(), want.float(), **tol)).sum())


def _step_parity(case, grad_accum, compress, moment_dtype=None):
    ref_cfg, cfg = _configs(case)
    if moment_dtype:
        ref_cfg = dataclasses.replace(ref_cfg, moment_dtype=moment_dtype)
        cfg = cfg.with_(moment_dtype=moment_dtype)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5, grad_accum=grad_accum,
              compress_grads=compress)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefTrainConfig(**kw)))
    step = make_train_step(cfg, TrainConfig(**kw))

    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    mdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    ref_opt = ref_adamw_init(params, moment_dtype=mdt)
    params, ref_opt, _ = ref_step(params, ref_opt, jax.tree.map(
        jnp.asarray, _batch(cfg, 99)))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_params_from_reference(_np(params),
                                                            cfg))
    opt = adamw_state_from_reference(_np(ref_opt), cfg)
    assert opt.step == 1 and any(bool(m.any()) for m in opt.mu.values())
    assert all(m.dtype == (torch.bfloat16 if moment_dtype == "bfloat16"
                           else torch.float32) for m in opt.mu.values())

    n_elems = sum(p.numel() for p in model.parameters())
    allowed = int(OUTLIERS * n_elems) if compress or moment_dtype else 0
    mu_tol, nu_tol = MU_TOL, NU_TOL
    if moment_dtype:
        mu_tol = dict(MU_TOL, rtol=BF16_MOMENT_RTOL)
        nu_tol = dict(NU_TOL, rtol=BF16_MOMENT_RTOL)
    for i in range(2):
        b = _batch(cfg, i)
        params, ref_opt, ref_m = ref_step(params, ref_opt,
                                          jax.tree.map(jnp.asarray, b))
        model, opt, m = step(model, opt, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        assert opt.step == int(ref_opt.step) == i + 2
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            assert float(m[k]) == pytest.approx(float(ref_m[k]), rel=rtol)
        want_p = transformer_params_from_reference(_np(params), cfg)
        want_o = adamw_state_from_reference(_np(ref_opt), cfg)
        outside = {
            "params": sum(_outside(p.detach(), want_p[n], P_TOL)
                          for n, p in model.named_parameters()),
            "mu": sum(_outside(opt.mu[n], want_o.mu[n], mu_tol)
                      for n in opt.mu),
            "nu": sum(_outside(opt.nu[n], want_o.nu[n], nu_tol)
                      for n in opt.nu)}
        assert all(v <= allowed for v in outside.values()), \
            (i, outside, allowed)
    return cfg, model


@pytest.mark.parametrize("case,accum,compress", STEP_CASES)
def test_train_step_matches_reference(case, accum, compress):
    _step_parity(case, accum, compress)


def test_train_step_drops_assignments_at_capacity_factor_1_25():
    """The cf 1.25 case above really drops: some of its batch's
    assignments overflow an expert's buffer in every layer."""
    from repro_torch.models import moe
    _, cfg = _configs("mixtral-8x7b-cf1.25")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ins = []
    with torch.no_grad():
        model(torch.from_numpy(_batch(cfg, 0)["tokens"]), ins)
    for blk, h in zip(model.blocks, ins):
        _, _, _, a_slot, _, cap = moe.route(blk.params(), h, cfg)
        assert (a_slot == cfg.n_experts * cap).any()


@pytest.mark.parametrize("case", ["internvl2-76b", "grok-1-314b"])
def test_train_step_with_bf16_moments_matches_reference(case):
    _step_parity(case, 1, False, moment_dtype="bfloat16")


# ---------------------------------------------------------------------------
# the int8 round trip over the reference's leaves
# ---------------------------------------------------------------------------

def _ref_round_trip(tree):
    def rt(g):
        q, s = ref_comp.compress_int8(g)
        return ref_comp.decompress_int8(q, s, g.shape, g.dtype)
    return jax.tree.map(rt, tree)


@pytest.mark.parametrize("n_layers", [5, 8])
def test_int8_round_trip_follows_the_hybrid_leaves(n_layers):
    """recurrentgemma at 5 layers (one group, a 2-layer tail) and 8 (two
    groups, a 2-layer tail): the port's round trip over its per-layer
    gradients equals the reference's over its ``groups`` / ``tail`` tree,
    bit for bit.  Each leaf's gradient has its own scale, so a block that
    ran across two reference leaves would quantize differently."""
    ref_cfg = dataclasses.replace(ref_get_config("recurrentgemma-2b",
                                                 smoke=True),
                                  n_layers=n_layers)
    cfg = get_config("recurrentgemma-2b", smoke=True).with_(
        n_layers=n_layers)
    assert reference_layout(cfg) == "groups"
    assert hybrid_grouping(cfg) == (n_layers // 3, 2)
    shapes = jax.eval_shape(lambda: ref_init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree.flatten(shapes)
    rng = np.random.default_rng(n_layers)
    grads = jax.tree.unflatten(treedef, [
        (rng.normal(size=s.shape) * 10.0 ** rng.uniform(-4, 0)
         ).astype(np.float32) for s in leaves])
    want = transformer_params_from_reference(
        _np(_ref_round_trip(jax.tree.map(jnp.asarray, grads))), cfg)
    port = {k: v.clone() for k, v in
            transformer_params_from_reference(grads, cfg).items()}
    got = int8_round_trip(port, cfg)
    assert set(got) == set(want)
    for n, g in got.items():
        assert torch.equal(g, want[n]), n


def test_layer_stacks_are_the_reference_leaves():
    """One group per reference leaf: blocks stack every layer; the
    hybrid's groups stack every plen-th layer below the tail; the tail's
    layers stand apart."""
    names = lambda cfg: list(Transformer(cfg, "cpu").state_dict())
    dense = get_config("qwen3-8b", smoke=True)
    stacks = layer_stacks(names(dense), dense)
    assert ["blocks.0.wq", "blocks.1.wq"] in stacks
    hyb = get_config("recurrentgemma-2b", smoke=True).with_(n_layers=8)
    stacks = layer_stacks(names(hyb), hyb)
    assert ["blocks.0.gate_proj", "blocks.3.gate_proj"] in stacks
    assert ["blocks.2.wq", "blocks.5.wq"] in stacks
    assert ["blocks.6.gate_proj"] in stacks and ["blocks.7.w_up"] in stacks
    assert sum(map(len, stacks)) == len(names(hyb))


# ---------------------------------------------------------------------------
# the loop and the launcher
# ---------------------------------------------------------------------------

LOOP_ARCHS = ["mixtral-8x7b", "mamba2-370m", "recurrentgemma-2b"]


def _trainer(arch, tmp, **kw):
    tc = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=50,
                     checkpoint_every=5, checkpoint_dir=str(tmp), **kw)
    return Trainer(get_config(arch, smoke=True), tc, "cpu", global_batch=4,
                   seq_len=32)


@pytest.mark.parametrize("arch", LOOP_ARCHS)
def test_trainer_loss_falls_and_resumes(arch, tmp_path):
    """The loop trains the family (the loss of its last steps below its
    first's), and a run resumed from a checkpoint after 2 steps equals an
    unbroken 4-step run exactly."""
    hist = _trainer(arch, tmp_path / "long").run(steps=8, log_every=0)
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    whole = _trainer(arch, tmp_path / "whole")
    whole.run(steps=4, log_every=0)
    _trainer(arch, tmp_path / "split").run(steps=2, log_every=0)
    resumed = _trainer(arch, tmp_path / "split")
    resumed.run(steps=2, log_every=0)
    assert resumed.step == whole.step == 4 and resumed.opt.step == 4
    for (n, p), q in zip(whole.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(whole.opt.mu[n], resumed.opt.mu[n]), n


def test_launch_train_runs_mixtral_as_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mixtral-8x7b", "--smoke", "--steps", "2", "--global-batch", "4",
         "--seq-len", "32", "--device", "cpu", "--checkpoint-dir",
         str(tmp_path / "ck")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "final loss:" in proc.stdout
    assert os.listdir(tmp_path / "ck") == ["step_000000000002"]


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-370m",
                                  "recurrentgemma-2b"])
def test_launch_train_builds_the_family(arch, tmp_path):
    trainer, _ = launch_train.build(["--arch", arch, "--smoke", "--device",
                                     "cpu", "--checkpoint-dir",
                                     str(tmp_path)])
    assert trainer.cfg.name == f"{arch}-smoke" and trainer.mesh is None


@pytest.mark.parametrize("arch,need", [("hubert-xlarge", "frames"),
                                       ("internvl2-76b", "vision")])
def test_loop_refuses_audio_and_vlm_and_the_step_trains_them(
        arch, need, tmp_path, capsys):
    """The Trainer and the launcher refuse the family (the token pipeline
    makes no frames or patch embeddings), pointing at make_train_step,
    which trains it on an explicit batch."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(ValueError, match=f"{need}.*make_train_step"):
        Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path)), "cpu", 2, 8)
    with pytest.raises(SystemExit):
        launch_train.build(["--arch", arch, "--smoke", "--device", "cpu",
                            "--checkpoint-dir", str(tmp_path)])
    assert "make_train_step" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, TrainConfig(lr=3e-3, warmup_steps=1))
    opt = adamw_init(dict(model.named_parameters()))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    losses = []
    for _ in range(4):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mixtral-8x7b-cf1.25", "mamba2-370m",
                                  "recurrentgemma-2b-5", "internvl2-76b",
                                  "hubert-xlarge"])
def test_remat_gives_the_plain_loss_and_grads(case):
    """remat "full" (each block recomputed in the backward) gives the
    plain loop's loss and gradients exactly, for every block kind."""
    _, cfg = _configs(case)
    plain = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    remat = Transformer(cfg.with_(remat="full"), device="cpu")
    remat.load_state_dict(plain.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    out = []
    for model in (plain, remat):
        model.requires_grad_(True)
        loss = train_loss(model, batch)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    (loss, grads), (loss_r, grads_r) = out
    assert torch.equal(loss, loss_r)
    for (n, _), g, g_r in zip(plain.named_parameters(), grads, grads_r):
        assert torch.equal(g, g_r), n
