"""Trainer: the train step and the fault-tolerant loop, on one device.

Port of ``src/repro/train/trainer.py``.  The step:

  * gradient accumulation over ``tc.grad_accum`` micro-batches (the
    batch's leading dim split in order) into float32 accumulators, each
    micro-batch's gradient divided by k;
  * the int8 round trip of every gradient with ``tc.compress_grads`` (the
    wire format of the cross-pod all-reduce; optim/compression.py), its
    256-element blocks running over each leaf as the reference stacks it
    (a block weight's layers end to end, :func:`int8_round_trip`);
  * global-norm clipping, then AdamW (updating the model's parameters in
    place) under the WSD, cosine or constant schedule;
  * metrics ``loss``, ``grad_norm`` and ``lr`` (the rate of the step
    taken).

The loop: stateless-seekable data (a restart replays identical batches),
async checkpoints every ``checkpoint_every`` steps and a final one, a
preemption-triggered stop, the straggler monitor, and auto-resume from
the newest complete checkpoint.

Only the dense family trains (:func:`check_trainable`): the other
families serve, but their training has not been held against the
reference (ROADMAP queue 1 item 7).

No mesh: the reference's FSDP x TP shardings, donation, ``seq_parallel``
and tensor parallelism have no meaning on one device and come with the
sharded trainer (ROADMAP queue 1 item 3).  PyTorch runs eagerly, so there
is no jit; the micro-batch scan is a Python loop.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.data.synthetic import TokenPipeline
from repro_torch.kernels.logic_dsp.ops import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params, train_loss
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               resolve_moment_dtype, wsd_schedule)
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.resilience import PreemptionGuard, StragglerMonitor


def _default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"        # cosine | wsd | const
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_accum: int = 1
    compress_grads: bool = False    # int8 EF compression of DP grads
    checkpoint_every: int = 200
    checkpoint_dir: str = field(default_factory=_default_checkpoint_dir)
    keep_checkpoints: int = 3
    seed: int = 0


def make_lr_fn(tc: TrainConfig):
    if tc.schedule == "wsd":
        stable = int(tc.total_steps * 0.8) - tc.warmup_steps
        decay = tc.total_steps - tc.warmup_steps - stable
        return wsd_schedule(tc.lr, tc.warmup_steps, max(stable, 1),
                            max(decay, 1))
    if tc.schedule == "cosine":
        return cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)
    return lambda step: torch.tensor(tc.lr, dtype=torch.float32)


def layer_stacks(names) -> list[list[str]]:
    """The parameter names grouped as the reference's tree stacks them:
    ``blocks.{i}.{name}`` for every layer i, in order, is one leaf
    (``blocks/{name}`` of shape (n_layers, ...)); any other name is a leaf
    of its own."""
    groups: dict[str, list[str]] = {}
    for n in names:
        parts = n.split(".")
        groups.setdefault(parts[2] if parts[0] == "blocks" else n,
                          []).append(n)
    return list(groups.values())


def int8_round_trip(grads: dict) -> dict:
    """Each gradient quantized to int8 and back (``compress_int8`` then
    ``decompress_int8`` in its own dtype), the blocks running over each
    reference leaf: a block weight's layers are quantized end to end, so
    a block may span two layers exactly where the reference's does."""
    out = {}
    for names in layer_stacks(grads):
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        q, s = compress_int8(flat)
        rec = decompress_int8(q, s, flat.shape, flat.dtype)
        for n, piece in zip(names, rec.split([grads[n].numel()
                                              for n in names])):
            out[n] = piece.view(grads[n].shape)
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.  The model's parameters are trained (their
    ``requires_grad`` is turned on) and updated in place; ``opt_state`` is
    an :class:`AdamWState` keyed by the parameters' names; ``batch`` holds
    ``tokens`` (B, S).  The metrics are 0-d float32 tensors."""
    lr_fn = make_lr_fn(tc)
    resolve_moment_dtype(cfg.moment_dtype)   # validate early

    def grads_of(model, params, batch):
        loss = train_loss(model, batch)
        return loss.detach(), torch.autograd.grad(loss, list(params.values()))

    def compute_grads(model, params, batch):
        if tc.grad_accum <= 1:
            loss, grads = grads_of(model, params, batch)
            return loss, dict(zip(params, grads))
        k = tc.grad_accum
        micro = {kk: v.reshape(k, v.shape[0] // k, *v.shape[1:])
                 for kk, v in batch.items()}
        dev = model.device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for n, p in params.items()}
        for i in range(k):
            mb_loss, g = grads_of(model, params,
                                  {kk: v[i] for kk, v in micro.items()})
            for a, x in zip(acc.values(), g):
                a.add_(x.float() / k)
            del g
            loss = loss + mb_loss / k
        return loss, acc

    def train_step(model: Transformer, opt_state: AdamWState, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss, grads = compute_grads(model, params, batch)
        if tc.compress_grads:
            # the int8 round trip models the wire format of the cross-pod
            # all-reduce; its quantization error is what convergence must
            # absorb
            grads = int8_round_trip(grads)
        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
        _, new_opt = adamw_update(grads, opt_state, params, lr=lr_fn,
                                  weight_decay=tc.weight_decay)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "lr": lr_fn(opt_state.step + 1)}
        return model, new_opt, metrics

    return train_step


def check_trainable(cfg: ModelConfig) -> None:
    """The port trains the dense family only: no other family's training
    (its loss, gradients, the int8 round trip over its layer stacks) has
    been held against the reference."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family is not ported "
            "(ROADMAP queue 1 item 7); the port trains the dense family")


class Trainer:
    """The training loop on one device (CUDA unless ``device="cpu"``).
    After :meth:`run` the trained model and optimizer state stay on the
    trainer as ``model`` and ``opt``."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, device,
                 global_batch: int, seq_len: int):
        check_trainable(cfg)
        self.cfg, self.tc = cfg, tc
        self.device = resolve_device(device)
        self.pipeline = TokenPipeline(cfg.vocab_size, global_batch, seq_len,
                                      seed=tc.seed)
        self.ckpt = CheckpointManager(tc.checkpoint_dir,
                                      keep=tc.keep_checkpoints)
        self.monitor = StragglerMonitor()
        self.guard = PreemptionGuard().install()
        self.step = 0
        # honour cfg.moment_dtype (e.g. grok1's bf16 moments)
        self.moment_dtype = resolve_moment_dtype(cfg.moment_dtype)
        self.train_step = make_train_step(cfg, tc)
        self.model: Transformer | None = None
        self.opt: AdamWState | None = None

    # ---- state ----
    def init_state(self) -> tuple[Transformer, AdamWState]:
        model = init_params(self.cfg, torch.Generator(
            self.device).manual_seed(self.tc.seed), self.device)
        model.requires_grad_(True)
        return model, adamw_init(dict(model.named_parameters()),
                                 self.moment_dtype)

    def state(self, model: Transformer, opt: AdamWState) -> dict:
        """The tree a checkpoint holds."""
        return {"params": model.state_dict(), "opt": opt}

    def maybe_resume(self, model, opt):
        if self.ckpt.latest_step is None:
            return model, opt
        restored, meta = self.ckpt.restore(self.state(model, opt))
        model.load_state_dict(restored["params"])
        self.step = int(meta.get("data_step", self.ckpt.latest_step))
        print(f"[trainer] resumed from step {self.step}")
        return model, restored["opt"]

    def batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipeline.batch(step).items()}

    # ---- loop ----
    def run(self, steps: int, log_every: int = 10) -> list[dict]:
        model, opt = self.init_state()
        model, opt = self.maybe_resume(model, opt)
        history = []
        for _ in range(steps):
            if self.guard.should_stop:
                print("[trainer] preemption: checkpoint + stop")
                break
            t0 = time.monotonic()
            model, opt, metrics = self.train_step(model, opt,
                                                  self.batch(self.step))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            if self.monitor.record(dt):
                print(f"[trainer] WARNING straggler: step {self.step} "
                      f"took {dt:.2f}s (median {self.monitor.median:.2f}s)")
            self.step += 1
            metrics["step"] = self.step
            metrics["seconds"] = dt
            history.append(metrics)
            if log_every and self.step % log_every == 0:
                print(f"step {self.step}: loss {metrics['loss']:.4f} "
                      f"({dt:.2f}s)")
            if self.step % self.tc.checkpoint_every == 0:
                self.ckpt.save_async(self.step, self.state(model, opt),
                                     meta={"data_step": self.step})
        self.ckpt.save(self.step, self.state(model, opt),
                       meta={"data_step": self.step})
        self.model, self.opt = model, opt
        return history
