"""The port's checkpointing, resilience monitors, remat, padded-vocab
gradient, ``Trainer`` and training launcher, on the CPU.

The checkpoint and resilience tests are the reference's
(``tests/test_train.py:88-161``) on the port's classes; the trainer tests
are the reference's three ``Trainer`` tests (``tests/test_train.py:
164-189``, which fail on the reference's mesh layer) on the port's
``Trainer`` with ``device="cpu"``.  The remat paths must give the plain
loop's loss and gradients exactly (the same operations, recomputed); the
padded-vocabulary gradient agrees with ``jax.grad`` of the reference's
``train_loss`` at 1e-5, relative to each leaf's largest element (float32
sums in another order; an element that is a cancellation keeps only the
leaf's absolute error).
"""
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
from repro.models.transformer import train_loss as ref_train_loss
from repro_torch.configs import get_config
from repro_torch.convert import transformer_params_from_reference
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import Transformer, init_params, train_loss
from repro_torch.optim import adamw_init
from repro_torch.train import (CheckpointManager, Heartbeat, StragglerMonitor,
                               TrainConfig, Trainer)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def restore_signal_handlers():
    """``Trainer`` installs a PreemptionGuard on SIGTERM and SIGINT."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


def test_checkpoint_roundtrip(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.randn(3, 4).to(torch.bfloat16)},
            "step": 7}
    mgr.save(7, tree, meta={"data_step": 7})
    like = {"a": torch.zeros(10), "b": {"c": torch.zeros(3, 4,
                                                         dtype=torch.bfloat16)},
            "step": 0}
    restored, meta = mgr.restore(like)
    assert meta["data_step"] == 7 and restored["step"] == 7
    assert (restored["a"].numpy() == np.arange(10)).all()
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])   # all 16 bits


def test_checkpoint_keeps_bf16_in_16_bits(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, {"w": torch.ones(512, dtype=torch.bfloat16)})
    d = os.path.join(ckpt_dir, "step_000000000001")
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        assert data["w"].dtype == np.int16
    restored, _ = mgr.restore({"w": torch.zeros(512)})    # cast on restore
    assert restored["w"].dtype == torch.float32
    assert (restored["w"] == 1).all()


def test_checkpoint_snapshot_is_taken_at_save(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir)
    w = torch.zeros(4)
    mgr.save_async(1, {"w": w})
    w.add_(1.0)                    # the trainer updates in place
    restored, _ = mgr.restore({"w": torch.ones(4)})
    assert not restored["w"].any()


def test_checkpoint_async_and_gc(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir, keep=2)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree)
    mgr.wait()
    assert mgr.latest_step == 4
    steps = sorted(int(d[5:]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    assert steps == [3, 4]      # gc kept newest 2


def test_checkpoint_ignores_partial(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, {"w": torch.ones(2)})
    # simulate a crash mid-save: step dir without manifest
    os.makedirs(os.path.join(ckpt_dir, "step_000000000099"))
    assert mgr.latest_step == 1


def test_checkpoint_shape_mismatch_raises(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones(3)})


# ---------------------------------------------------------------------------
# resilience
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_sustained_outliers():
    m = StragglerMonitor(min_samples=5, consecutive=3)
    flagged = False
    for _ in range(20):
        flagged |= m.record(1.0)
    assert not flagged
    m.record(5.0)
    m.record(5.0)
    assert not m.record(1.0)    # hysteresis resets on a good step
    for _ in range(2):
        m.record(5.0)
    assert m.record(5.0)        # 3 consecutive -> alarm


def test_heartbeat_detects_dead_host():
    hb = Heartbeat(timeout=10.0)
    hb.beat("host0", now=0.0)
    hb.beat("host1", now=5.0)
    assert hb.dead_hosts(now=12.0) == ["host0"]


# ---------------------------------------------------------------------------
# the model's training paths
# ---------------------------------------------------------------------------

def _grads(model, tokens):
    model.requires_grad_(True)
    loss = train_loss(model, {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_plain_loss_and_grads(remat):
    cfg = get_config("qwen3-8b", smoke=True)
    plain = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = Transformer(cfg.with_(remat=remat), device="cpu")
    model.load_state_dict(plain.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    loss, grads = _grads(plain, tokens)
    loss_r, grads_r = _grads(model, tokens)
    assert torch.equal(loss, loss_r)
    for g, g_r in zip(grads, grads_r):
        assert torch.equal(g, g_r)


@pytest.mark.parametrize("arch", ["qwen3-8b", "minicpm-2b"])
def test_padded_vocab_gradient_matches_reference(arch):
    """A vocabulary of 500 pads to 512: the pad logits are filled in place
    after the head's product; the gradient equals the reference's and is
    zero in the pad columns of the head (the tied embedding's pad rows
    too: no token selects them)."""
    ref_cfg = ref_get_config(arch, smoke=True).with_(vocab_size=500)
    cfg = get_config(arch, smoke=True).with_(vocab_size=500)
    assert cfg.padded_vocab == 512
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_params_from_reference(
        jax.tree.map(np.asarray, params), cfg))
    tokens = np.random.default_rng(1).integers(0, 500, (2, 16),
                                               dtype=np.int32)
    ref_loss, ref_g = jax.value_and_grad(ref_train_loss)(
        params, ref_cfg, {"tokens": jnp.asarray(tokens)})
    want = transformer_params_from_reference(jax.tree.map(np.asarray, ref_g),
                                             cfg)
    loss, grads = _grads(model, torch.from_numpy(tokens))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    head = dict(zip([n for n, _ in model.named_parameters()], grads))
    pad = head["embed"][500:] if cfg.tie_embeddings else \
        head["lm_head"][:, 500:]
    assert not pad.any()


# ---------------------------------------------------------------------------
# trainer end-to-end (the reference's Trainer tests, on the CPU)
# ---------------------------------------------------------------------------

def _mk_trainer(tmp, **tc_kw):
    cfg = get_config("qwen3-8b", smoke=True)
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=50,
                     checkpoint_every=5, checkpoint_dir=str(tmp), **tc_kw)
    return Trainer(cfg, tc, "cpu", global_batch=8, seq_len=32)


def test_trainer_loss_decreases_and_resumes(tmp_path):
    tr = _mk_trainer(tmp_path / "c1")
    hist = tr.run(steps=10, log_every=0)
    assert len(hist) == 10
    assert all(np.isfinite(h["loss"]) for h in hist)
    # resume continues the step counter from the checkpoint
    tr2 = _mk_trainer(tmp_path / "c1")
    tr2.run(steps=2, log_every=0)
    assert tr2.step == 12


def test_resume_equals_an_unbroken_run(tmp_path):
    """4 steps in one go == 2 steps, checkpoint, a fresh trainer resuming
    for 2 more: parameters, moments and the step agree exactly on the
    CPU."""
    whole = _mk_trainer(tmp_path / "whole")
    whole.run(steps=4, log_every=0)
    _mk_trainer(tmp_path / "split").run(steps=2, log_every=0)
    resumed = _mk_trainer(tmp_path / "split")
    resumed.run(steps=2, log_every=0)
    assert resumed.step == whole.step == 4 and resumed.opt.step == 4
    for (n, p), q in zip(whole.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(whole.opt.nu[n], resumed.opt.nu[n]), n


def test_grad_accum_matches_full_batch(tmp_path):
    """accum=2 over the same global batch gives (near-)identical updates."""
    t1 = _mk_trainer(tmp_path / "a", grad_accum=1)
    t2 = _mk_trainer(tmp_path / "b", grad_accum=2)
    h1 = t1.run(steps=3, log_every=0)
    h2 = t2.run(steps=3, log_every=0)
    for a, b in zip(h1, h2):
        assert a["loss"] == pytest.approx(b["loss"], rel=2e-3)


def test_compressed_grads_still_converge(tmp_path):
    tr = _mk_trainer(tmp_path / "c", compress_grads=True)
    hist = tr.run(steps=8, log_every=0)
    assert np.isfinite(hist[-1]["loss"])


def test_trainer_state_is_the_model_and_adamw(tmp_path):
    tr = _mk_trainer(tmp_path / "s")
    model, opt = tr.init_state()
    assert all(p.requires_grad for p in model.parameters())
    assert set(opt.mu) == set(dict(model.named_parameters())) and \
        opt.step == 0
    again, _ = tr.init_state()          # seeded with tc.seed
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 again.parameters()))
    assert adamw_init({"w": torch.ones(2)}).mu["w"].dtype == torch.float32


def test_trainer_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path)), None, 8, 32)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_runs_as_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minicpm-2b", "--smoke", "--steps", "3", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path / "ck")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "final loss:" in proc.stdout
    assert os.listdir(tmp_path / "ck") == ["step_000000000003"]


def test_launch_train_uses_the_arch_schedule_and_refuses_model_parallel(
        tmp_path):
    trainer, args = launch_train.build(
        ["--arch", "minicpm-2b", "--smoke", "--steps", "20", "--device",
         "cpu", "--checkpoint-dir", str(tmp_path)])
    assert trainer.tc.schedule == "wsd" and trainer.tc.warmup_steps == 2
    trainer, _ = launch_train.build(
        ["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path)])
    assert trainer.tc.schedule == "cosine" and trainer.mesh is None
    # one process has no mesh of 2 ranks
    with pytest.raises(SystemExit):
        launch_train.build(["--arch", "minicpm-2b", "--smoke",
                            "--model-parallel", "2", "--device", "cpu"])


def test_launch_train_takes_the_host_mesh_under_a_process_group(
        tmp_path, monkeypatch):
    """With torchrun's environment (here a group of one rank) the
    launcher trains on the host mesh, and refuses a --model-parallel that
    does not divide the group."""
    from repro_torch.launch.mesh import destroy, free_port
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    try:
        trainer, _ = launch_train.build(
            ["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
             "--model-parallel", "1", "--checkpoint-dir", str(tmp_path)])
        assert trainer.mesh.mesh_dim_names == ("data", "model")
        assert tuple(trainer.mesh.shape) == (1, 1)
        with pytest.raises(SystemExit):
            launch_train.build(["--arch", "qwen3-8b", "--smoke", "--device",
                                "cpu", "--model-parallel", "2"])
    finally:
        destroy()
