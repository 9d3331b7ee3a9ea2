"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --smoke --steps 100 --global-batch 8 --seq-len 128 [--device cpu]

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-8b --smoke --model-parallel 2 [--device cpu]

The port's counterpart of ``src/repro/launch/train.py``, with the
reference's flags and the architecture's own ``LR_SCHEDULE`` (minicpm's
WSD; cosine otherwise).  Under torchrun (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` set) every rank joins the process group
(NCCL on CUDA, gloo with ``--device cpu``) and trains on the host mesh
(data, model) = (world / ``--model-parallel``, ``--model-parallel``),
the sharded trainer; so does a caller that started a process group
itself before :func:`build`.  A ``--model-parallel`` that does not divide
the world is refused.  Without a group it trains in one process on one
device (``--device``: CUDA unless ``cpu``), and refuses a
``--model-parallel`` above 1, since one process has no mesh of that
size.  It trains the dense, moe, ssm and hybrid families; the audio and
vlm families, whose loss reads frames or patch embeddings that the
loop's token pipeline does not make, are refused before anything is
built, with the ``Trainer``'s message (``trainer.check_loop_trainable``):
they train through ``make_train_step`` on an explicit batch.
"""
from __future__ import annotations

import argparse
import importlib

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.registry import _MODULES
from repro_torch.launch.mesh import (distributed_env, init_distributed,
                                     make_host_mesh)
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import (_default_checkpoint_dir,
                                       check_loop_trainable)


def build(argv=None) -> tuple[Trainer, argparse.Namespace]:
    """Parse the launcher's flags and build its :class:`Trainer`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default=_default_checkpoint_dir())
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="where the model trains: CUDA unless 'cpu'")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    try:
        check_loop_trainable(cfg)
    except ValueError as e:
        ap.error(str(e))
    mesh, device = None, args.device
    if distributed_env():
        device = init_distributed(args.device)
    if dist.is_initialized():
        try:
            mesh = make_host_mesh(model=args.model_parallel, device=device)
        except ValueError as e:
            ap.error(str(e))
    elif args.model_parallel > 1:
        ap.error(f"--model-parallel {args.model_parallel} needs a mesh of "
                 f"{args.model_parallel} ranks; one process has none: run "
                 "it under torchrun")

    # arch-specific recipe (e.g. minicpm's WSD schedule)
    mod = importlib.import_module(_MODULES[args.arch])
    schedule = getattr(mod, "LR_SCHEDULE", "cosine")

    tc = TrainConfig(
        lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10), schedule=schedule,
        grad_accum=args.grad_accum, compress_grads=args.compress_grads,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    return Trainer(cfg, tc, device, args.global_batch, args.seq_len,
                   mesh=mesh), args


def main(argv=None) -> list[dict]:
    trainer, args = build(argv)
    history = trainer.run(args.steps)
    if history:
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"(from {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
