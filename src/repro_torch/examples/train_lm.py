"""End-to-end LM training run: a ~100M-parameter model, a few hundred
steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
        [--resume] [--device cpu]

The port's counterpart of ``examples/train_lm.py`` (CUDA unless
``--device cpu``): the sharded trainer on the host mesh (FSDP x TP rules
degrade gracefully to one rank: a process group of this process alone, or
every rank torchrun starts), the trainer's step (WSD schedule, gradient
accumulation over 2 micro-batches, clipping, AdamW), async checkpointing
and auto-resume (``--resume`` keeps the checkpoint directory), the
straggler monitor and the stateless-seekable data pipeline.
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.mesh import (destroy, distributed_env,
                                     init_distributed, init_single_process,
                                     make_host_mesh)
from repro_torch.train import TrainConfig, Trainer


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--resume", action="store_true",
                    help="keep checkpoint dir (demonstrates auto-resume)")
    ap.add_argument("--device", default=None,
                    help="where the model trains: CUDA unless 'cpu'")
    args = ap.parse_args(argv)

    # ~100M params: qwen3-style block at width 512
    cfg = get_config("qwen3-8b").with_(
        name="qwen3-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=1536, vocab_size=32000, remat="none",
        seq_parallel=False, param_dtype="float32", compute_dtype="float32")
    n_params = cfg.param_count()
    print(f"model: {cfg.name}, {n_params / 1e6:.0f}M params")

    ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    if not args.resume:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tc = TrainConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps,
                     schedule="wsd", grad_accum=2,
                     checkpoint_dir=ckpt_dir, checkpoint_every=100)
    device = init_distributed(args.device) if distributed_env() else \
        init_single_process(args.device)
    try:
        mesh = make_host_mesh(device=device)
        trainer = Trainer(cfg, tc, device, global_batch=8, seq_len=256,
                          mesh=mesh)
        history = trainer.run(args.steps, log_every=25)
    finally:
        destroy()
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} over {len(history)} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return history


if __name__ == "__main__":
    main()
