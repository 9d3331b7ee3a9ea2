"""Trainer: the train step and the fault-tolerant loop, on one device or
on a DeviceMesh.

Port of ``src/repro/train/trainer.py``.  The step:

  * gradient accumulation over ``tc.grad_accum`` micro-batches (the
    batch's leading dim split in order) into float32 accumulators, each
    micro-batch's gradient divided by k;
  * the int8 round trip of every gradient with ``tc.compress_grads`` (the
    wire format of the cross-pod all-reduce; optim/compression.py), its
    256-element blocks running over each leaf as the reference stacks it
    (a stacked weight's layers end to end, :func:`int8_round_trip`);
  * global-norm clipping, then AdamW (updating the model's parameters in
    place) under the WSD, cosine or constant schedule;
  * metrics ``loss``, ``grad_norm`` and ``lr`` (the rate of the step
    taken).

The loop: stateless-seekable data (a restart replays identical batches),
async checkpoints every ``checkpoint_every`` steps and a final one, a
preemption-triggered stop, the straggler monitor, and auto-resume from
the newest complete checkpoint.

The step trains every family on the batch its loss reads: ``tokens``
(dense, moe, ssm, hybrid), ``frames`` and ``labels`` (audio), ``tokens``
and ``vision`` (vlm).  The loop feeds a ``TokenPipeline``, tokens only,
so :class:`Trainer` refuses the audio and vlm families
(:func:`check_loop_trainable`), whose inputs the reference's loop cannot
feed either; they train through :func:`make_train_step`.

With a mesh (``Trainer(..., mesh=)``, a ``torch.distributed``
``DeviceMesh`` with dims ('data', 'model') or ('pod', 'data', 'model'))
the step is :func:`make_sharded_train_step`: the reference's FSDP x TP
shardings as DTensor placements, each rank its rows of the batch, each
weight gathered when the model uses it and its gradient reduce-scattered
back into the storage block (``train/parallel.py``); the loop
runs under ``activation_sharding(mesh)``, and checkpoints gather each
leaf whole (rank 0 writes) and restore onto the trainer's placements.
Without a mesh nothing changes.  PyTorch runs eagerly, so there is no
jit or donation; the micro-batch scan is a Python loop.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.convert import reference_layout
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.kernels.logic_dsp.ops import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec_utils import activation_sharding
from repro_torch.models.transformer import (Transformer, hybrid_grouping,
                                            init_params, train_loss)
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               resolve_moment_dtype, wsd_schedule)
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.parallel import ShardedModel, batch_rows
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


def layer_stacks(names, cfg: ModelConfig) -> list[list[str]]:
    """The parameter names grouped as the reference's tree stores them
    (``convert.reference_layout``), each group one reference leaf with its
    layers in order: ``blocks``, ``blocks.{i}.{name}`` over every layer;
    ``groups``, for pattern position j the layers j, j + plen, ... below
    ``n_groups * plen`` (``groups[j]/{name}``), each tail layer's names
    apart; ``layers``, every layer's names apart.  A top-level name is a
    leaf of its own."""
    layout = reference_layout(cfg)
    plen = len(cfg.block_pattern) if layout == "groups" else 1
    stacked = cfg.n_layers if layout == "blocks" else \
        hybrid_grouping(cfg)[0] * plen if layout == "groups" else 0
    stacks: dict = {}
    for n in sorted(names, key=lambda n: int(n.split(".")[1])
                    if n.startswith("blocks.") else -1):
        parts = n.split(".")
        key = n
        if parts[0] == "blocks" and int(parts[1]) < stacked:
            key = (int(parts[1]) % plen, parts[2])
        stacks.setdefault(key, []).append(n)
    return list(stacks.values())


def int8_round_trip(grads: dict, cfg: ModelConfig) -> dict:
    """Each gradient quantized to int8 and back (``compress_int8`` then
    ``decompress_int8`` in its own dtype), the 256-element blocks running
    over each reference leaf (:func:`layer_stacks`): a stacked weight's
    layers are quantized end to end, so a block may span two layers
    exactly where the reference's does."""
    out = {}
    for names in layer_stacks(grads, cfg):
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        q, s = compress_int8(flat)
        rec = decompress_int8(q, s, flat.shape, flat.dtype)
        for n, piece in zip(names, rec.split([grads[n].numel()
                                              for n in names])):
            out[n] = piece.view(grads[n].shape)
    return out


def check_loop_trainable(cfg: ModelConfig) -> None:
    """The :class:`Trainer` feeds a ``TokenPipeline``, which makes tokens
    only: refuse a family whose loss reads another input."""
    if cfg.family in ("audio", "vlm"):
        need = "frames and their labels" if cfg.family == "audio" else \
            "stub patch embeddings ('vision') beside the tokens"
        raise ValueError(
            f"{cfg.name} ({cfg.family}) trains on {need}, and the "
            "Trainer's TokenPipeline makes tokens only (the reference's "
            "Trainer fails on the missing input); train it through "
            "make_train_step with an explicit batch")


def _grads_of(model, params, batch):
    loss = train_loss(model, batch)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


def compute_grads(model: Transformer, params: dict, batch: dict,
                  grad_accum: int = 1) -> tuple[torch.Tensor, dict]:
    """(loss, {name: gradient}) of ``batch`` with respect to ``params``:
    with ``grad_accum`` k > 1 the batch's leading dim is split in order
    into k micro-batches, each one's gradient divided by k and summed
    into float32 accumulators of ``params``' shapes (a sharded step's
    storage blocks), and the loss is the mean of theirs."""
    if grad_accum <= 1:
        loss, grads = _grads_of(model, params, batch)
        return loss, dict(zip(params, grads))
    k = grad_accum
    micro = {kk: v.reshape(k, v.shape[0] // k, *v.shape[1:])
             for kk, v in batch.items()}
    dev = model.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for n, p in params.items()}
    for i in range(k):
        mb_loss, g = _grads_of(model, params,
                               {kk: v[i] for kk, v in micro.items()})
        for a, x in zip(acc.values(), g):
            a.add_(x.float() / k)
        del g
        loss = loss + mb_loss / k
    return loss, acc


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.  The model's parameters are trained (their
    ``requires_grad`` is turned on) and updated in place; ``opt_state`` is
    an :class:`AdamWState` keyed by the parameters' names; ``batch`` holds
    the inputs of the family's loss, each with the rows on its leading
    dim: ``tokens`` (B, S); for audio ``frames`` (B, S, frontend_dim) and
    ``labels`` (B, S); for vlm ``tokens`` (B, S_t) and ``vision`` (B,
    n_vis, D).  Micro-batches split every key.  The metrics are 0-d
    float32 tensors."""
    lr_fn = make_lr_fn(tc)
    resolve_moment_dtype(cfg.moment_dtype)   # validate early

    def train_step(model: Transformer, opt_state: AdamWState, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss, grads = compute_grads(model, params, batch, tc.grad_accum)
        if tc.compress_grads:
            # the int8 round trip models the wire format of the cross-pod
            # all-reduce; its quantization error is what convergence must
            # absorb
            grads = int8_round_trip(grads, cfg)
        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
        _, new_opt = adamw_update(grads, opt_state, params, lr=lr_fn,
                                  weight_decay=tc.weight_decay)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "lr": lr_fn(opt_state.step + 1)}
        return model, new_opt, metrics

    return train_step


def make_sharded_train_step(cfg: ModelConfig, tc: TrainConfig,
                            rows: tuple) -> Callable:
    """``train_step(sharded, opt_state, batch) -> (sharded, opt_state,
    metrics)`` for a :class:`~repro_torch.train.parallel.ShardedModel`:
    the step of :func:`make_train_step` on this rank's rows (``batch``)
    with respect to the storage blocks, each weight gathered where the
    model uses it and each micro-batch's gradient reduce-scattered into
    float32 accumulators of the storage blocks' shapes, then reduced over
    the batch axes, and the clip and AdamW on each rank's blocks
    (``train/parallel.py``).  ``rows`` is ``parallel.batch_rows``'s
    (slice, axes, n)."""
    lr_fn = make_lr_fn(tc)
    resolve_moment_dtype(cfg.moment_dtype)
    _, axes, n = rows

    def train_step(sm: ShardedModel, opt_state: AdamWState, batch: dict):
        # the storage blocks: each micro-batch's gradient reaches them
        # reduce-scattered by the gathers' backward
        params = sm.trainable(axes, sm.splits(batch))
        loss, grads = compute_grads(sm.module, params, batch, tc.grad_accum)
        loss, grads = sm.reduce(loss, grads, n)
        if tc.compress_grads:
            # the round trip over each whole leaf, as the reference's
            # blocks run over its global (layer-stacked) gradient
            whole = int8_round_trip({k: sm.whole(k, g)
                                     for k, g in grads.items()}, cfg)
            grads = {k: sm.to_storage(k, g) for k, g in whole.items()}
        grads, gnorm = sm.clip(grads, tc.clip_norm)
        new_opt = sm.adamw(grads, opt_state, lr=lr_fn,
                           weight_decay=tc.weight_decay)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "lr": lr_fn(opt_state.step + 1)}
        return sm, new_opt, metrics

    return train_step


class Trainer:
    """The training loop on one device (CUDA unless ``device="cpu"``), or
    on ``mesh``, a DeviceMesh over the whole process group whose ranks
    each run this loop on their own ``device``.  After :meth:`run` the
    trained model (a :class:`~repro_torch.train.parallel.ShardedModel`
    under a mesh) and optimizer state stay on the trainer as ``model``
    and ``opt``.  Families whose loss reads more than tokens (audio, vlm)
    are refused (:func:`check_loop_trainable`)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, device,
                 global_batch: int, seq_len: int, mesh=None):
        check_loop_trainable(cfg)
        self.cfg, self.tc = cfg, tc
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rows = None
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot train "
                                 f"on {self.device}")
            if mesh.size() != dist.get_world_size():
                raise ValueError(f"the mesh spans {mesh.size()} of the "
                                 f"process group's {dist.get_world_size()} "
                                 "ranks; it must span them all")
            self.rows = batch_rows(mesh, global_batch,
                                   include_model=not cfg.tensor_parallel)
        self.pipeline = TokenPipeline(cfg.vocab_size, global_batch, seq_len,
                                      seed=tc.seed)
        self.ckpt = CheckpointManager(tc.checkpoint_dir,
                                      keep=tc.keep_checkpoints)
        self.monitor = StragglerMonitor()
        self.guard = PreemptionGuard().install()
        self.step = 0
        # honour cfg.moment_dtype (e.g. grok1's bf16 moments)
        self.moment_dtype = resolve_moment_dtype(cfg.moment_dtype)
        self.train_step = make_train_step(cfg, tc) if mesh is None else \
            make_sharded_train_step(cfg, tc, self.rows)
        self.model: Transformer | ShardedModel | None = None
        self.opt: AdamWState | None = None

    # ---- state ----
    def init_state(self):
        """(model, AdamW state): every rank draws the whole model from the
        seed, as on one device; under a mesh each keeps its blocks."""
        model = init_params(self.cfg, torch.Generator(
            self.device).manual_seed(self.tc.seed), self.device)
        model.requires_grad_(True)
        if self.mesh is not None:
            sharded = ShardedModel(model, self.mesh)
            return sharded, sharded.init_opt(self.moment_dtype)
        return model, adamw_init(dict(model.named_parameters()),
                                 self.moment_dtype)

    def state(self, model, opt: AdamWState) -> dict:
        """The tree a checkpoint holds (the same keys with a mesh or
        without, so either restores the other's)."""
        params = model.params if self.mesh is not None else \
            model.state_dict()
        return {"params": params, "opt": opt}

    def maybe_resume(self, model, opt):
        if self.ckpt.latest_step is None:
            return model, opt
        restored, meta = self.ckpt.restore(
            self.state(model, opt),
            shardings=None if self.mesh is None else model.layouts())
        if self.mesh is not None:
            model.load(restored["params"])
        else:
            model.load_state_dict(restored["params"])
        self.step = int(meta.get("data_step", self.ckpt.latest_step))
        print(f"[trainer] resumed from step {self.step}")
        return model, restored["opt"]

    def batch(self, step: int) -> dict:
        """Step ``step``'s batch, this rank's rows under a mesh."""
        rows = slice(None) if self.rows is None else self.rows[0]
        return {k: torch.from_numpy(v[rows]).to(self.device)
                for k, v in self.pipeline.batch(step).items()}

    def _should_stop(self) -> bool:
        """The preemption flag, agreed by every rank under a mesh (one
        rank leaving the loop alone would hang the others' collectives)."""
        if self.mesh is None or self.mesh.size() == 1:
            return self.guard.should_stop
        flag = torch.tensor(float(self.guard.should_stop),
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    # ---- loop ----
    def run(self, steps: int, log_every: int = 10) -> list[dict]:
        with activation_sharding(self.mesh):
            return self._run(steps, log_every)

    def _run(self, steps: int, log_every: int) -> list[dict]:
        model, opt = self.init_state()
        model, opt = self.maybe_resume(model, opt)
        history = []
        for _ in range(steps):
            if self._should_stop():
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
