"""The paper's technique inside an LM: FFCL-substituted FFN blocks.

    PYTHONPATH=src python -m repro_torch.examples.logic_mlp_swap [--device cpu]

The port's counterpart of ``examples/logic_mlp_swap.py`` at its widths
(2 layers, d_model 48, d_ff 24, vocab 256): it trains a tiny transformer
whose FFNs are *binarized* (NullaNet-compatible, STE gradients), captures
each FFN's input bits on calibration batches, converts each FFN's binary
hidden map into a fixed-function combinational logic program (ISF ->
espresso -> gates -> sub-kernel schedule) and serves the model through the
logic fabric: the FFN matmul ``w_in`` disappears, and on the card each
FFN's hidden layer is one K1 launch (``logic_ffn_apply`` ->
``logic_forward`` -> ``logic_cuda_call``).  The model is the port's
``Transformer`` with ``cfg.logic_mlp``; its forward is the example's
(float32 embedding, no pad columns at vocab 256, ``x @ lm_head``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.spec import CompileSpec
from repro_torch.data import TokenPipeline
from repro_torch.kernels.logic_dsp.ops import resolve_device
from repro_torch.models import logic_mlp
from repro_torch.models.layers import softmax_xent
from repro_torch.models.transformer import (Transformer, init_params,
                                            train_loss)
from repro_torch.optim import adamw_init, adamw_update

# the reference example's widths and recipe (examples/logic_mlp_swap.py)
SWAP = dict(n_layers=2, d_model=48, d_ff=24, n_heads=4, n_kv_heads=2,
            head_dim=12, vocab_size=256)
STEPS, LR, N_UNIT = 150, 2e-3, 16
CALIB_FIRST, CALIB_BATCHES, HELD_OUT = 900, 8, 1234


def swap_config():
    return get_config("qwen3-8b", smoke=True).with_(**SWAP, logic_mlp=True)


def pipeline(cfg, seed: int = 0) -> TokenPipeline:
    return TokenPipeline(cfg.vocab_size, global_batch=8, seq_len=32,
                         seed=seed)


@torch.no_grad()
def init_swap_model(cfg, seed: int, device) -> Transformer:
    """The model from a generator seeded with ``seed``, its FFNs replaced
    by binarized ones: w_in 0.5 N(0, 1), b_in 0, w_out 0.1 N(0, 1)."""
    gen = torch.Generator(device).manual_seed(seed)
    model = init_params(cfg, gen, device)
    for blk in model.blocks:
        blk.w_in.copy_(0.5 * torch.randn(blk.w_in.shape, generator=gen,
                                         device=model.device))
        blk.b_in.zero_()
        blk.w_out.copy_(0.1 * torch.randn(blk.w_out.shape, generator=gen,
                                          device=model.device))
    return model


def tokens_of(pipe: TokenPipeline, step: int, device) -> torch.Tensor:
    return torch.from_numpy(pipe.batch(step)["tokens"]).to(device)


def train_ste(model: Transformer, pipe: TokenPipeline, steps: int = STEPS,
              lr: float = LR, log=print) -> list[float]:
    """STE training, the reference's ``step_fn``: the next-token loss
    through the binarized FFNs, its gradient, AdamW at ``lr`` (weight
    decay 0.1, no clipping) on batch ``step`` of ``pipe``.  Returns each
    step's loss (before its update)."""
    params = dict(model.named_parameters())
    model.requires_grad_(True)
    opt = adamw_init(params)
    losses = []
    for step in range(steps):
        loss = train_loss(model, {"tokens": tokens_of(pipe, step,
                                                      model.device)})
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt = adamw_update(dict(zip(params, grads)), opt, params, lr=lr)
        losses.append(loss.detach())
        if step % 50 == 0:
            log(f"step {step}: loss {float(losses[-1]):.4f}")
    model.requires_grad_(False)
    return [float(v) for v in losses]


@torch.inference_mode()
def capture_bits(model: Transformer, batches) -> list[np.ndarray]:
    """Each layer's FFN input bits (h >= 0) over ``batches``, (N, D)
    uint8 per layer, from the binarized model."""
    captured = [[] for _ in model.blocks]
    for tokens in batches:
        ins = []
        model(tokens, ffn_inputs=ins)
        for i, h in enumerate(ins):
            captured[i].append((h >= 0).reshape(-1, h.shape[-1]))
    return [torch.cat(c).cpu().numpy().astype(np.uint8) for c in captured]


def convert(model: Transformer, calib_bits, n_unit: int = N_UNIT,
            log=print) -> list[dict]:
    """NullaNet conversion of each layer's xb -> h map; sets each block's
    ``program`` (its FFN then runs on the logic fabric).  Returns per
    layer: samples, distinct patterns, gates, steps and seconds."""
    out = []
    for i, (blk, bits) in enumerate(zip(model.blocks, calib_bits)):
        t0 = time.perf_counter()
        blk.program = logic_mlp.ffn_to_program(
            blk.params(), bits, CompileSpec(n_unit=n_unit), name=f"ffn{i}")
        out.append({"samples": len(bits),
                    "distinct_patterns": len(np.unique(bits, axis=0)),
                    "gates": blk.program.n_gates,
                    "steps": blk.program.n_steps,
                    "convert_s": time.perf_counter() - t0})
        log(f"layer {i}: FFCL program {blk.program.n_gates} gates, "
            f"{blk.program.n_steps} sub-kernel steps")
    return out


@torch.inference_mode()
def forward_with(model: Transformer, tokens, programs,
                 ffn_inputs: list | None = None) -> torch.Tensor:
    """The logits with each block's FFN on ``programs`` (None: the
    binarized STE FFN)."""
    for blk, prog in zip(model.blocks, programs):
        blk.program = prog
    return model(tokens, ffn_inputs=ffn_inputs)


def compare(model: Transformer, programs, tokens) -> dict:
    """STE against logic-fabric forward on ``tokens``: both losses and the
    next-token argmax agreement."""
    ste = forward_with(model, tokens, [None] * len(programs))
    logic = forward_with(model, tokens, programs)
    v = model.cfg.vocab_size
    return {"loss_ste": float(softmax_xent(ste[:, :-1], tokens[:, 1:])),
            "loss_logic": float(softmax_xent(logic[:, :-1], tokens[:, 1:])),
            "argmax_agreement": float((ste[..., :v].argmax(-1) ==
                                       logic[..., :v].argmax(-1)).float()
                                      .mean())}


def run(device=None, log=print) -> dict:
    """The example end to end on ``device`` (CUDA unless ``"cpu"``):
    each step's loss, each layer's conversion, the held-out comparison."""
    dev = resolve_device(device)
    cfg = swap_config()
    model = init_swap_model(cfg, 0, dev)
    pipe = pipeline(cfg)
    losses = train_ste(model, pipe, STEPS, LR, log)

    # ISF density drives held-out fidelity (paper §7.1: the samples are a
    # tiny fraction of the 2^48 input space; more calibration -> better
    # don't-care assignments). Capture several batches.
    calib = [tokens_of(pipe, CALIB_FIRST + i, dev)
             for i in range(CALIB_BATCHES)]
    layers = convert(model, capture_bits(model, calib), log=log)
    programs = [blk.program for blk in model.blocks]
    held = compare(model, programs, tokens_of(pipe, HELD_OUT, dev))
    log(f"loss: STE {held['loss_ste']:.4f} vs logic-fabric "
        f"{held['loss_logic']:.4f}")
    log(f"next-token argmax agreement: {held['argmax_agreement']:.3f} "
        f"(ISF is exact on observed patterns; held-out patterns may "
        f"diverge, paper §7.1)")
    return {"losses": losses, "layers": layers, "held_out": held}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model runs: CUDA unless 'cpu'")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
