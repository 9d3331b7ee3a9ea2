"""Serving launcher: prefill per request + continuous-batching decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --smoke --requests 8 --prompt-len 16 --max-new 8 [--device cpu]

The port's counterpart of ``src/repro/launch/serve.py`` on ``--device``
(CUDA unless ``cpu``), for the decoder families: dense, moe, ssm and
hybrid.  It refuses an encoder (audio), as the reference does, and the
vlm family: its prefill needs stub patch embeddings (``vision=``), which
the reference's launcher never passes (it dies with ``KeyError:
'vision'``), and neither package has a vision front end to make them.
Drive a vlm through ``serve.prefill(..., vision=...)`` and
``serve.decode_step`` instead.  The loop is the reference's: each
admitted request is prefilled into its slot's own cache, then every
active slot decodes one token (slot caches differ in length, so each
decodes alone, batch 1), and a finished slot's cache is dropped for the
next admission.  As in the reference, a slot's first decode feeds the
prompt's last token again.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.logic_dsp.ops import resolve_device
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serve import Request, RequestBatcher, decode_step, prefill


@torch.inference_mode()
def serve(model: Transformer, prompts, *, batch_size: int, max_new: int,
          context: int) -> dict:
    """Serve one request per prompt through a :class:`RequestBatcher` of
    ``batch_size`` slots.  Returns the finished requests and the host
    clock's seconds: the whole loop, each prefill (to the device's end)
    and each decode step (ended by reading its token on the host).  Runs
    under ``torch.inference_mode()``."""
    batcher = RequestBatcher(batch_size)
    for uid, prompt in enumerate(prompts):
        batcher.submit(Request(uid=uid, prompt=prompt,
                               max_new_tokens=max_new))
    dev = model.device
    prefill_s, decode_s = [], []
    t0 = time.perf_counter()
    caches = [None] * batch_size
    while not batcher.idle:
        for slot, req in batcher.admit():
            t1 = time.perf_counter()
            _, caches[slot] = prefill(
                model, torch.as_tensor(req.prompt, device=dev)[None],
                context=context)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prefill_s.append(time.perf_counter() - t1)
        active = [i for i, c in enumerate(caches) if c is not None
                  and batcher.slots[i] is not None]
        if not active:
            continue
        toks = np.zeros((batch_size,), np.int64)
        for i in active:
            gen = batcher.slots[i].generated
            toks[i] = gen[-1] if gen else batcher.slots[i].prompt[-1]
        nxt = np.full((batch_size,), -1, np.int64)
        for i in active:   # per-slot decode (slot caches differ in length)
            t1 = time.perf_counter()
            logits, caches[i] = decode_step(
                model, torch.tensor([[toks[i]]], device=dev), caches[i])
            nxt[i] = int(torch.argmax(logits[0, -1]))
            decode_s.append(time.perf_counter() - t1)
        done_before = len(batcher.finished)
        batcher.record_tokens(nxt)
        for i in range(batch_size):
            if batcher.slots[i] is None and caches[i] is not None \
                    and len(batcher.finished) > done_before:
                caches[i] = None
    return {"finished": batcher.finished, "n_steps": len(decode_s),
            "seconds": time.perf_counter() - t0, "prefill_s": prefill_s,
            "decode_s": decode_s}


def check_servable(cfg) -> None:
    """Refuse what the launcher cannot serve: an encoder, and a vlm (no
    vision front end makes its prefill's patch embeddings)."""
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    if cfg.family == "vlm":
        raise SystemExit(
            f"{cfg.name} (vlm) needs stub patch embeddings for each "
            "prompt, and the launcher has no vision front end to make "
            "them (the reference's launcher fails on the missing "
            "'vision' input); call serve.prefill(..., vision=...) and "
            "serve.decode_step directly")


def make_prompts(cfg, n: int, prompt_len: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, prompt_len, dtype=np.int32)
            for _ in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--context", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model runs: CUDA unless 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    check_servable(cfg)
    dev = resolve_device(args.device)
    model = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                        dev)
    r = serve(model, make_prompts(cfg, args.requests, args.prompt_len,
                                  args.seed),
              batch_size=args.batch_size, max_new=args.max_new,
              context=args.context)
    dt, n_steps = r["seconds"], r["n_steps"]
    print(f"served {args.requests} requests, {n_steps} decode steps "
          f"in {dt:.2f}s ({n_steps / max(dt, 1e-9):.1f} tok/s) on {dev}")
    for req in r["finished"][:4]:
        print(f"  req {req.uid}: {req.generated}")


if __name__ == "__main__":
    main()
