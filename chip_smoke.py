#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU (an H100 by design).

Run from the root of a checkout:  ``python3 chip_smoke.py``

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc
(and counts the tensor-core instructions in K3's SASS), holds each kernel
bit-exactly against its plain PyTorch version on the card and against the
numpy oracle, in both of K1/K2's scratch variants (shared memory, and
device memory for a program too large for it), then drives the serving
path at full width:
a LeNet-5 ``fc1`` NullaNet layer (400 inputs, 120 neurons, each an ISF
sampled on 400 patterns; weights and patterns from ``--seed``) synthesized
with the port's ``layer_to_graph`` and served by ``LogicEngine`` through
the mega kernel, monolithic and as a 4-program parallel pipeline, plus the
monolithic program through ``logic_infer_bits`` (the single-program
kernel K1, launched as the mega kernel's one-stage case), and checks
that every path took the scratch variant its size implies.  Finally it
times both kernels at the main path's shapes (with their time per step,
and the device-memory variant), and the engine's waves (median and p90 of 100, a per-phase split from CUDA
events, and a torch.profiler window for the device's idle share).
``sharded_serving``: the engine's split path across devices (the
reference's ``shard_map``) on the one card, fc1 and its pipeline through
``LogicEngine(shard=True)`` and over two shards of ``cuda:0``, bit-exact
against the oracle and the unsharded engine with one K2 launch a shard a
wave.

Then the XNOR-popcount GEMM (K3): bit-exact against its plain version on
ragged shapes, driven through ``xnor_gemm`` at the two full-width shapes of
the paper's XNOR baseline (VGG16 conv6 and LeNet-5 fc1), exact against
``torch._int_mm`` on the +-1 int8 operands, and timed beside it.  Last the
NullaNet flow: ``run_flow`` trains a binarized MLP at LeNet-5's FC widths
(400 -> 120 -> 84 -> 10) on the card, converts both hidden layers to logic
and runs them through all four backends (plain, K1 per layer, K2 for the
stack, the engine), which must agree bit for bit; then the default
(exact, enumerated) configuration, whose logic must keep the binarized
model's accuracy exactly.

Then the service around the engine.  ``calibrate``: the wall-clock
calibration's probe grid measured on the card through the phase-split K1
path, fitted, saved as the ``torch-cuda`` record and loaded back in a fresh
process with no re-fit, the phase path bit-exact against the fused one and
the oracle, and the ``n_unit`` the fit picks for fc1.  ``frontdoor``: a
``FrontDoor`` with two tenants, fc1 and LeNet-5's ``fc2`` (120 -> 84,
synthesized the same way from its own seed), at capacity 8192 with an
artifact store behind it, driven by a light Poisson trace, a closed loop
that finds the saturated rate, and a Poisson overload with faults injected,
each tenant's program evicted and reloaded from the store between them.
``warm_start``: fc1 and fc2 precompiled into a fresh store by the port's
precompile tool and served from a fresh process with zero compiles.

Then the slice that brings a user's own logic and an LM onto the card.
``quickstart``: the paper's quickstart (a Verilog module parsed,
synthesized, scheduled and run through K1) against direct evaluation and
its ground truth.  ``logic_ffn``: a 2-layer transformer whose FFNs are
binarized, converted to gate programs from calibration bits and run
through K1 (the logic-FFN swap).  ``lm``: qwen3-8b at full width and depth
from random weights, prefill plus decode held against the forward in
float32, then served in bf16 by the continuous-batching launcher.  The
front door's phase ends with the reference's own 2x load point, whose
latency bound is reported, and the warm-start phase audits its store with
``repro_torch.tools.verify_program``.

Then LM training.  ``train_full``: minicpm-2b at its full config (2.7 B
parameters, bf16, float32 moments, remat "full", WSD) trained by
``launch/train.py``'s Trainer for a few steps of 8 x 512 tokens with a
checkpoint, one step profiled, then the loss on one fixed batch made to
fall.  ``train_parity``: the same widths at 2 layers in float32, one step
on the card against the CPU, and a resumed run against an unbroken one.
``sharded_train``: the sharded trainer on a one-rank NCCL group and its
(1, 1) mesh, one full-width float32 step against the one-device step and
every leaf's placements against the rule table, then minicpm-2b at full
size through the launcher on the mesh.  ``logic_swap_train``: the
logic-FFN swap trained with STE, converted and served through K1, with
its held-out agreement.

Then the other model families at their published widths, random weights
from ``--seed`` (``families``, one line each): mixtral-8x7b (MoE, 16 of
32 layers served), mamba2-370m (SSM), recurrentgemma-2b (hybrid),
internvl2-76b (the VLM backbone with 256 stub patch embeddings, 16 of 80
layers) and hubert-xlarge (the audio encoder over stub frames).  Each:
float32 prefill + decode against the forward on the card (mixtral at a
capacity factor where nothing can drop, then at its config's 1.25 with
the drops reported; mamba2 over a ragged chunk; recurrentgemma past its
local-window ring), the float32 forward on the card against the CPU's,
then serving in bf16 through ``launch/serve.py``'s loop (internvl2
through ``prefill(vision=)`` / ``decode_step``; hubert's encoder
forward), every request finished with in-vocabulary ids.  They launch no
ported kernel.

Last the same families trained at full width in bf16
(``train_families``, one line each): mamba2-370m and recurrentgemma-2b
through ``launch/train.py``'s Trainer with their checkpoints,
mixtral-8x7b (2 of 32 layers), internvl2-76b (2 of 80 layers, 256 stub
patch embeddings + 256 tokens) and hubert-xlarge (512 frames with
labels) through ``make_train_step``; each with the loss falling on a
fixed batch and a float32 step card against CPU, mixtral's also on a
one-rank (1, 1) mesh.

Output, one JSON object per line: ``env``, ``build``, ``parity``,
``main_path``, ``timing``, ``engine``, ``sharded_serving``, ``xnor``,
``flow``, ``calibrate``, ``frontdoor``, ``warm_start``, ``quickstart``,
``logic_ffn``, ``lm``, ``train_full``, ``dryrun``, ``train_parity``,
``sharded_train``, ``logic_swap_train``, ``families`` and
``train_families`` (one line per model and a last one with the phase's
kernel launches); then the
card's name and power limit as nvidia-smi prints them; then a ``kernels``
line (per kernel: its launches on the main paths, its largest difference
from the plain version, its device time per call, the plain version's
time, the card's bound and the library call's device time; K1/K2's
scratch variant and time per step, K3's tensor-core instruction); and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the last line.  Without CUDA, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
INT32_LANES_PER_SM = 64              # int32 ops per SM per clock
# H100 SXM dense int8 tensor-core peak at 700 W (data sheet; it gives no
# b1 rate)
INT8_OPS_PER_S = 1.979e15
# K3's route and its rate: b1 mma.sync m16n8k256 with AND-popc, as
# tools/torch_mma_probe.py measured it on an H100 80GB HBM3 at 700 W,
# in int8-style operations (2 per bit multiply-add).  The card's peak for
# a +-1 product is the faster of the two, so K3's bound takes this one.
K3_ROUTE = "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc"
B1_MMA_OPS_PER_S = 1.0008750828700428e16
PM1_OPS_PER_S = max(INT8_OPS_PER_S, B1_MMA_OPS_PER_S)
TC_SASS = r"\b(?:BMMA|IMMA|HMMA|[HIB]GMMA)[\w.]*"
K1_REPLACES = "src/repro/kernels/logic_dsp/kernel.py:96"
K2_REPLACES = "src/repro/kernels/logic_dsp/kernel.py:204"
K3_REPLACES = "src/repro/kernels/xnor_gemm/kernel.py:44"
KERNEL_SOURCE = "src/repro_torch/csrc/logic_dsp.cu"
K3_SOURCE = "src/repro_torch/csrc/xnor_gemm.cu"
BATCHES = (1, 31, 32, 33, 70, 8192)
# a program too large for a block's shared memory (rows past 2**16): the
# device-memory scratch variant
BIG_GATES = 66_000
# LeNet-5 fc1 at the paper's geometry (benchmarks/workloads.py LENET5_LAYERS)
FANIN, NEURONS, ISF_SAMPLES = 400, 120, 400
CAPACITY = 8192                      # samples per engine wave
MAX_GATES = 12000                    # partition budget of the pipelined cell
TIMED_WAVES = 100                    # p90 of 100 waves has 10 beyond it
# K3 at the full-width shapes of the paper's XNOR baseline
# (benchmarks/workloads.py): (M, N, k)
XNOR_SHAPES = {
    # VGG16 conv6: 256 images x 8*8 patches, 256 filters, fanin 3*3*256
    "vgg16_conv6": (256 * 8 * 8, 256, 3 * 3 * 256),
    # LeNet-5 fc1: one engine wave of samples, 120 neurons, fanin 400
    "lenet5_fc1": (CAPACITY, NEURONS, FANIN),
}
XNOR_PARITY = ([(64, 48, 100), (128, 128, 512), (17, 5, 33), (256, 64, 2304)]
               + [(m, n, k) for m in (1, 17, 4097) for n in (1, 17, 4097)
                  for k in (1, 33, 100, 2304)])
# the NullaNet flow at LeNet-5's FC widths: 400 ISF training samples (as
# fc1 above) and one full engine wave of validation samples
FLOW_WIDTHS = dict(n_features=FANIN, hidden=(NEURONS, 84), n_classes=10)
FLOW_TRAIN, FLOW_VAL = ISF_SAMPLES, CAPACITY
# the calibration's probe grid as tools/calibrate.py runs it (--quick)
CAL_BATCH, CAL_REPS = 1024, 5
# the front door's second tenant, LeNet-5 fc2 (benchmarks/workloads.py:46)
FC2_NEURONS = 84
# request sizes as TrafficPattern draws them by default (geometric, mean
# 24, at most 256), per-tenant inflight cap as the front-door example
FD_SIZE_MEAN, FD_SIZE_MAX, FD_MAX_INFLIGHT = 24, 256, 8
FD_DEADLINE_S = 2.0
# the light trace offers FD_LIGHT_LOAD / L (L: one mean-size request's
# latency alone), which one-at-a-time service already sustains; the
# overload offers FD_OVERLOAD x R_sat (R_sat: the closed-loop completion
# rate with every tenant at its inflight cap, an over-estimate of what
# Poisson arrivals get), so it is an overload whatever batching does
FD_LIGHT_LOAD, FD_LIGHT_REQUESTS = 0.2, 400
FD_OVERLOAD, FD_OVERLOAD_REQUESTS = 4.0, 1200
FD_SAT_S = 1.0
FD_FAULTS = dict(seed=7, drop_rate=0.02, delay_rate=0.02, delay_s=0.002)
# the reference's own 2x load point (tests/test_frontdoor.py:400-447): the
# unloaded p99 from sequential requests, 2 x capacity / wave / 24 requests
# a second split over a Poisson and a Pareto tenant, eviction and delay
# faults; its bound 3 x unloaded p99 + 75 ms is reported, not gated
FD2X_SEQUENTIAL, FD2X_REQUESTS, FD2X_SIZE_MAX, FD2X_DEADLINE_S = 20, 50, 96, 0.4
FD2X_FAULTS = dict(seed=5, evict_rate=0.2, delay_rate=0.1, delay_s=0.002)
# the LM serving path: qwen3-8b at full width and depth; parity in float32
# on LM_PARITY_TOKENS tokens (prefill all but the last LM_PARITY_DECODE,
# decode those) against the forward at the reference test's tolerance
# (tests/test_serve.py:29-37), then serving in the config's bf16 at
# launch/serve.py's defaults
LM_ARCH = "qwen3-8b"
LM_PARITY_BATCH, LM_PARITY_TOKENS, LM_PARITY_DECODE = 2, 16, 4
LM_PARITY_TOL = 2e-3
LM_SERVE = dict(requests=8, batch_size=4, prompt_len=16, max_new=8,
                context=64)
LM_TRACED_STEPS = 8
# the logic-FFN swap at the widths of the reference's own example
# (examples/logic_mlp_swap.py:38-46): calibration from TokenPipeline(256,
# 8, 32) batches 900.., a held-out batch 1234, n_unit 16
LOGIC_FFN = dict(n_layers=2, d_model=48, d_ff=24, n_heads=4, n_kv_heads=2,
                 head_dim=12, vocab_size=256, logic_mlp=True)
LOGIC_FFN_CALIB, LOGIC_FFN_HELD_OUT, LOGIC_FFN_UNIT = 8, 1234, 16
# LM training: minicpm-2b at its full config (bf16 params, float32
# moments, remat "full", WSD) through launch/train.py's Trainer; the
# fixed-batch descent check at a constant lr on a fresh optimizer state;
# one step profiled.  MFU against the H100 SXM's dense bf16 peak.
TRAIN_ARCH = "minicpm-2b"
TRAIN_FULL = dict(steps=6, global_batch=8, seq_len=512, grad_accum=2)
TRAIN_DESCENT_STEPS, TRAIN_DESCENT_LR = 4, 3e-4
BF16_FLOPS_PER_S = 989e12
# the dry run (repro_torch.launch.dryrun): qwen3-8b's train_4k and
# decode_32k cells at pod1 (a fake 256-rank group, fake CUDA tensors) in
# subprocesses, held against the results the CPU's fake tensors gave
# (results/dryrun_torch); and train_full's own cell (TRAIN_FULL on one
# rank) held against the step train_full ran on the card
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "decode_32k"))
DRYRUN_FLOPS_RTOL = 1e-6
# full width at 2 layers in float32 (TF32 off): one step on the card
# against the same step on the CPU, then resume against an unbroken run
TRAIN_PARITY = dict(n_layers=2, global_batch=2, seq_len=128, grad_accum=2,
                    lr=1e-3)
TRAIN_PARITY_RTOL = 1e-4             # loss and grad_norm, card vs CPU
TRAIN_RESUME_RTOL = 1e-3             # |resumed - unbroken| / |update|
# the split path across devices: fc1 and its 4-program pipeline through
# LogicEngine(shard=True) and over two shards on the one card; waves timed
SHARD_SLABS = 4
SHARD_TIMED_WAVES = 30
# the sharded trainer on a one-rank NCCL group and a (1, 1) mesh: the
# parity step at full width and TRAIN_PARITY's layers in float32 against
# the one-device step, then minicpm-2b at full size through the launcher
SHARDED_TRAIN = dict(steps=3, global_batch=8, seq_len=512)
SHARDED_STEP_RTOL = 1e-6             # loss and grad_norm; params: atol
# the other families at full width, random weights from --seed: per model
# the layers of each run (its whole depth where it fits; a cut is listed
# under "reduced"), and the float32 self-consistency run's batch, tokens
# (the prompt is all but the last `decode`) and decode steps; mixtral's
# runs at capacity factor n_experts / k (nothing can drop), then again at
# its config's 1.25 (reported, not gated).  mamba2's prompt of 100 spans
# two chunks of 64 (the second ragged); recurrentgemma's prefill of 2,040
# then 16 steps wraps its local-window ring of 2,048.  hubert-xlarge is an
# encoder: no self-consistency run and no decode; its serving is the
# forward over FAMILY_FRAMES stub frames (batch x frames, 10 s at 50 Hz).
FAMILIES = {
    "mixtral-8x7b": dict(serve=16, self_check=4, vs_cpu=2, batch=2,
                         tokens=16, decode=4),
    "mamba2-370m": dict(serve=48, self_check=48, vs_cpu=48, batch=2,
                        tokens=104, decode=4),
    "recurrentgemma-2b": dict(serve=26, self_check=26, vs_cpu=26, batch=1,
                              tokens=2056, decode=16),
    "internvl2-76b": dict(serve=16, self_check=4, vs_cpu=2, batch=2,
                          tokens=16, decode=4),
    "hubert-xlarge": dict(serve=48, self_check=None, vs_cpu=48),
}
# the families' training at full width (train_families): bf16 with each
# config's moment dtype and remat, TRAIN_FAMILY's rows x positions a
# step, no accumulation.  Per model: "layers", the depth (None: whole; a
# cut only where 80 GB forces it, listed under "reduced"); "route",
# launch/train.py's build (its Trainer and final checkpoint) or
# make_train_step on explicit batches (the vlm's "vision" stub patch
# embeddings before its tokens, the audio's frames with labels: the
# Trainer's token pipeline makes neither; mixtral's, to keep the phase
# near 300 s: through the launcher its 31.6 GB checkpoint took 45.7 s on
# an H100 80GB HBM3 at 700 W);
# "parity", the depth of the float32 step held card against CPU (the
# smallest that keeps the family's structure: recurrentgemma one (rec,
# rec, attn) group and the 2-layer tail); "mesh", that step also on a
# one-rank NCCL (1, 1) mesh
TRAIN_FAMILIES = {
    "mixtral-8x7b": dict(layers=2, route="step", parity=1, mesh=True),
    "mamba2-370m": dict(layers=None, route="launcher", parity=2),
    "recurrentgemma-2b": dict(layers=None, route="launcher", parity=5),
    "internvl2-76b": dict(layers=2, route="step", parity=1, vision=256),
    "hubert-xlarge": dict(layers=None, route="step", parity=2),
}
TRAIN_FAMILY = dict(steps=4, global_batch=8, seq_len=512)
# the fixed-batch descent: a batch the run has not seen (batch 0, seen in
# the first step, was memorized by that one step: internvl2's loss on it
# started at 1e-7), at lr 1e-4, about one bf16 step of a weight at the
# init's scale (0.02): at 3e-4 Adam's sign-like first steps overshot on
# hubert-xlarge's 48-layer encoder (6.34 -> 6.44 -> 6.23 -> 6.66 on an
# H100 80GB HBM3 at 700 W)
TRAIN_FAMILY_DESCENT = dict(lr=1e-4, batch=1000)
# the float32 step (TF32 off) at a constant lr of 1e-4: Adam's first step
# moves an element by at most lr (plus its decay), so a parameter can
# differ by 1e-4 only where its gradient's sign does
TRAIN_FAMILY_PARITY = dict(global_batch=2, seq_len=64, lr=1e-4, vision=32)
TRAIN_FAMILY_PARITY_TOL = 1e-4       # loss, grad_norm (rel); params (abs)
FAMILY_PARITY_TOL = 2e-3             # prefill + decode against forward
# card against CPU in float32 (TF32 off): the same 1e-4 that holds the
# packages together on the CPU (float32 sums of up to 28,672 terms in
# another order; train_parity's full-width float32 step agrees to ~1e-7)
FAMILY_VS_CPU_TOL = 1e-4
FAMILY_VS_CPU_TOKENS = 32            # batch 1; vlm: after its vision tokens
FAMILY_FRAMES = (4, 500)
FAMILY_SERVE = dict(LM_SERVE)
FAMILY_TRACED_STEPS = 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(fields: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200,
                    help="kernel launches per timing")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc" / "logic_dsp.cu").is_file():
        print("chip_smoke.py runs from the root of a checkout: "
              f"{SRC / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available; chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 3
    run(args, torch)
    return 0


def run(args, torch) -> None:
    import numpy as np

    from repro_torch.core.gate_ir import LogicGraph, random_graph
    from repro_torch.core.nullanet import layer_to_graph
    from repro_torch.core.scheduler import (build_megaprogram,
                                            compile_graph,
                                            execute_megaprogram_np,
                                            execute_program_np)
    from repro_torch.core.spec import CompileSpec
    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.kernels.logic_dsp import ops
    from repro_torch.serve import LogicEngine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    props = torch.cuda.get_device_properties(dev)
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int32_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * \
        clock_mhz * 1e6
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "sms": props.multi_processor_count, "max_sm_clock_mhz": clock_mhz})

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    K.library()
    ptxas, kernel = {}, None                   # ptxas -v lines by kernel
    for ln in K.build_info["ptxas"].splitlines():
        if "entry function" in ln:
            kernel = ln.split("'")[1]
        elif kernel and ("Used" in ln or "spill" in ln):
            ptxas.setdefault(kernel, []).append(ln.strip())
    xnor_sass = tensor_core_sass(K.build_info["path"], "xnor_kernel")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": K.build_info["seconds"], "library":
          str(Path(K.build_info["path"]).relative_to(ROOT))
          if Path(K.build_info["path"]).is_relative_to(ROOT)
          else K.build_info["path"], "ptxas": ptxas,
          "xnor_kernel_tensor_core_sass": xnor_sass})
    check(sum(xnor_sass.values()) > 0,
          "xnor_kernel issues tensor-core instructions")

    max_err = {"logic": 0, "mega": 0}

    def bits_on_card(x_np):
        return torch.from_numpy(x_np).to(dev)

    # -- 2. each kernel against its plain version on the card ----------------
    def k1_case(prog, x_np):
        words = ops.pack_bits(bits_on_card(x_np))
        a = ops.program_arrays(prog, dev)
        args_ = (a["src_a"], a["src_b"], a["dst"], a["opcode"],
                 a["step_branch"], a["output_addrs"], words)
        got = ops.forward_words(*args_, n_addr=a["n_addr"], launch=a)
        plain = ops.forward_words(*args_, n_addr=a["n_addr"], use_ref=True)
        torch.cuda.synchronize()
        err = word_err(got, plain)
        max_err["logic"] = max(max_err["logic"], err)
        bits = ops.unpack_bits(got, len(x_np)).cpu().numpy()
        return err == 0 and bool((bits == execute_program_np(prog,
                                                             x_np)).all())

    def k2_case(mega, x_np):
        words = ops.pack_bits(bits_on_card(x_np))
        got = ops.mega_forward_words(mega, words)
        plain = ops.mega_forward_words(mega, words, use_ref=True)
        torch.cuda.synchronize()
        err = word_err(got, plain)
        max_err["mega"] = max(max_err["mega"], err)
        bits = ops.unpack_bits(got, len(x_np)).cpu().numpy()
        return err == 0 and bool((bits == execute_megaprogram_np(
            mega, x_np)).all())

    rng = np.random.default_rng(args.seed)

    def rand_bits(batch, n):
        return rng.integers(0, 2, (batch, n)).astype(bool)

    def passthrough(n, order=None):
        g = LogicGraph(n, name="pass")
        g.set_outputs([g.input_wire(i) for i in (order or range(n))])
        return g

    t0 = time.perf_counter()
    K.reset_launch_counts()                     # parity starts here
    cases = failed = 0
    k1_progs = []
    for n_unit in (8, 64, 256):
        for alloc in ("direct", "liveness"):
            g = random_graph(rng, 16, 3000, 12, unary_frac=0.2, locality=64)
            k1_progs.append((f"u{n_unit}_{alloc}", compile_graph(
                g, CompileSpec(n_unit=n_unit, alloc=alloc,
                               optimize="none"))))
    g = random_graph(rng, 16, 1500, 12, unary_frac=0.2, locality=64)
    mixed = compile_graph(g, CompileSpec(n_unit=32, opcode_sort=False,
                                         optimize="none"))
    check(bool((mixed.step_branch == 9).any()), "mixed-opcode steps exist")
    k1_progs.append(("mixed_opcodes", mixed))
    gateless = passthrough(16, list(range(15, -1, -1)))
    gateless.set_outputs(list(gateless.outputs) + [1, 0])
    k1_progs.append(("gateless", compile_graph(
        gateless, CompileSpec(n_unit=8, optimize="none"))))
    check(k1_progs[-1][1].n_steps == 0, "gateless program has no steps")
    results = {}
    for name, prog in k1_progs:
        for batch in BATCHES:
            ok = k1_case(prog, rand_bits(batch, prog.n_inputs))
            cases += 1
            failed += not ok
            results[f"K1/{name}/b{batch}"] = ok

    def stage_progs(layout, n_units):
        progs = []
        for stage, nu in zip(layout, n_units):
            gr = (passthrough(stage[1]) if stage[0] == "pass" else
                  random_graph(rng, *stage, unary_frac=0.2, locality=32))
            progs.append(compile_graph(gr, CompileSpec(n_unit=nu,
                                                       optimize="none")))
        return progs

    mega_cases = {
        "chain2": ([(16, 800, 12), (12, 600, 10)], [64, 64], None),
        "chain4_mixed_unit": ([(16, 800, 12), (12, 600, 12), (12, 500, 10),
                               (10, 300, 8)], [8, 256, 64, 16], None),
        "chain_gateless_first": ([("pass", 16), (16, 600, 10)], [8, 64],
                                 None),
        "chain_gateless_middle": ([(16, 600, 12), ("pass", 12),
                                   (12, 500, 8)], [64, 8, 256], None),
        "chain_gateless_last": ([(16, 600, 12), ("pass", 12)], [64, 8],
                                None),
        "chain_all_gateless": ([("pass", 16), ("pass", 16)], [8, 8], None),
        "parallel2": ([(16, 700, 6), (16, 500, 6)], [64, 64], "perm"),
        "parallel4_mixed_unit": ([(16, 700, 6), (16, 500, 4),
                                  (16, 600, 5), (16, 300, 3)],
                                 [8, 256, 64, 16], "perm"),
        "parallel_gateless_stage": ([(16, 700, 6), ("pass", 16)], [64, 8],
                                    "perm"),
    }
    big = compile_graph(random_graph(rng, 64, BIG_GATES, 32, unary_frac=0.2,
                                     locality=256),
                        CompileSpec(n_unit=256, alloc="direct",
                                    optimize="none"))
    check(ops.program_arrays(big, dev)["plan"].scratch == "device",
          f"{big.n_addr} rows take the device-memory scratch")
    for batch in (1, 33, 8192):
        ok = k1_case(big, rand_bits(batch, big.n_inputs))
        cases += 1
        failed += not ok
        results[f"K1/big_device/b{batch}"] = ok
    for name, (layout, n_units, perm) in mega_cases.items():
        progs = stage_progs(layout, n_units)
        mode = "parallel" if perm else "chain"
        kw = {}
        if perm:
            kw["output_perm"] = rng.permutation(
                sum(p.n_outputs for p in progs))
        mega = build_megaprogram(progs, mode=mode, **kw)
        for batch in BATCHES:
            ok = k2_case(mega, rand_bits(batch, mega.n_inputs))
            cases += 1
            failed += not ok
            results[f"K2/{name}/b{batch}"] = ok
    big_mega = build_megaprogram([big], mode="chain")
    for batch in (1, 33, 8192):
        ok = k2_case(big_mega, rand_bits(batch, big.n_inputs))
        cases += 1
        failed += not ok
        results[f"K2/big_device/b{batch}"] = ok
    by_variant = variant_counts(K)
    emit({"phase": "parity", "cases": cases, "failed": failed,
          "tolerance": 0, "max_abs_err": max_err, "seconds": time.perf_counter() - t0,
          "big_program": {"gates": big.n_gates, "n_addr": big.n_addr,
                          "steps": big.n_steps},
          "launches_by_variant": by_variant,
          "failures": sorted(k for k, ok in results.items() if not ok)})
    check(failed == 0, f"{failed} kernel/plain parity cases failed")
    check(by_variant["logic/device"] == 3 and by_variant["mega/device"] == 3,
          "only the program past shared memory took the device variant")

    # -- 3. the main path at full width: LeNet-5 fc1 -------------------------
    t0 = time.perf_counter()
    lrng = np.random.default_rng(args.seed)
    W = lrng.normal(size=(FANIN, NEURONS))
    b = 0.1 * lrng.normal(size=NEURONS)
    x_isf = lrng.integers(0, 2, (ISF_SAMPLES, FANIN)).astype(np.uint8)
    graph = layer_to_graph(x_isf, W, b, mode="isf", name="lenet5_fc1")
    synth_s = time.perf_counter() - t0
    check(graph.n_inputs == FANIN and graph.n_outputs == NEURONS,
          "fc1 graph is FANIN -> NEURONS")
    sizes = (1, 33, 700, 4096, 8192, 10000)
    requests = [rand_bits(n, FANIN) for n in sizes]
    spec_mono = CompileSpec(n_unit=256)
    spec_part = CompileSpec(n_unit=256, max_gates=MAX_GATES)
    engines = {
        "monolithic": LogicEngine(spec_mono, capacity=CAPACITY, device=dev),
        "parallel4": LogicEngine(spec_part, capacity=CAPACITY, device=dev),
    }
    plain_engines = {
        k: LogicEngine(e.spec, capacity=CAPACITY, device=dev, use_ref=True,
                       cache=e.cache) for k, e in engines.items()}

    K.reset_launch_counts()                     # main path starts here
    served = {}
    for name, eng in engines.items():
        before = K.launch_count("mega")
        t1 = time.perf_counter()
        uids = [eng.submit(graph, requests[0])]    # optimizes and compiles
        first_submit_s = time.perf_counter() - t1
        uids += [eng.submit(graph, x) for x in requests[1:]]
        eng.drain()
        torch.cuda.synchronize()
        served[name] = ([eng.result(u) for u in uids],
                        K.launch_count("mega") - before,
                        eng.stats()["invocations"], first_submit_s)
    arts = {name: artifact_of(eng) for name, eng in engines.items()}
    artifact = arts["monolithic"]
    prog = artifact.program
    x_k1 = rand_bits(CAPACITY, FANIN)
    k1_out = ops.logic_infer_bits(prog, x_k1, device=dev)
    torch.cuda.synchronize()
    launches = {"logic": K.launch_count("logic"),
                "mega": K.launch_count("mega")}   # main path ends here
    by_variant = variant_counts(K)

    check(launches["logic"] == 1, "logic_infer_bits made one K1 launch")
    for name, eng in engines.items():
        plan = ops.mega_arrays(artifact_of(eng).megaprogram(), dev)["plan"]
        check(plan.scratch == "shared",
              f"{name}: fc1 fits a block's shared memory")
    check(ops.program_arrays(prog, dev)["plan"].scratch == "shared",
          "K1's fc1 program fits shared memory")
    check(by_variant["logic/shared"] == launches["logic"] and
          by_variant["mega/shared"] == launches["mega"],
          f"the main path took the shared variant: {by_variant}")
    k1_oracle = artifact.execute(x_k1)
    check(bool((k1_out == k1_oracle).all()),
          "K1 on the fc1 program matches the numpy oracle")
    main = {"phase": "main_path",
            "model": f"LeNet-5 fc1 ({FANIN} -> {NEURONS})",
            "gates": graph.n_gates, "synth_s": synth_s,
            "requests": list(sizes), "launches": launches,
            "launches_by_variant": by_variant}
    for name, eng in engines.items():
        outs, k2_launches, waves, first_submit_s = served[name]
        art = arts[name]
        check(k2_launches == waves and waves > 0,
              f"{name}: one K2 launch per wave ({k2_launches} vs {waves})")
        plain_outs = [plain_engines[name].serve(graph, x) for x in requests]
        for x, out, plain in zip(requests, outs, plain_outs):
            check(out.shape == (len(x), NEURONS), f"{name}: output shape")
            check(bool((out == art.execute(x)).all()),
                  f"{name}: {len(x)} samples match the numpy oracle")
            check(bool((out == plain).all()),
                  f"{name}: {len(x)} samples match the plain engine")
        mega = art.megaprogram()
        main[name] = {"programs": len(art.programs),
                      "steps": mega.total_steps,
                      "n_addr": [p.n_addr for p in art.programs],
                      "gates": [p.n_gates for p in art.programs],
                      "compile_s": art.compile_s,
                      "first_submit_s": first_submit_s, "waves": waves,
                      "k2_launches": k2_launches}
    check(main["parallel4"]["programs"] > 1,
          "the max_gates budget gives a multi-program pipeline")
    emit(main)
    check(launches["mega"] > 0 and launches["logic"] > 0,
          "every kernel of the path launched")

    # -- 4. times at the main path's shapes ----------------------------------
    def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    words = ops.pack_bits(bits_on_card(rand_bits(CAPACITY, FANIN)))
    w = words.shape[1]

    def k1_calls(p, x):
        a = ops.program_arrays(p, dev)
        args_ = (a["src_a"], a["src_b"], a["dst"], a["opcode"],
                 a["step_branch"], a["output_addrs"], x)
        return (lambda: K.logic_cuda_call(a["rec"], x, a["output_addrs"],
                                          n_addr=p.n_addr, plan=a["plan"]),
                lambda: ops.forward_words(*args_, n_addr=p.n_addr,
                                          use_ref=True))

    k1, k1_plain = k1_calls(prog, words)
    max_err["logic"] = max(max_err["logic"], word_err(k1(), k1_plain()))

    def mega_call(mega):
        m = ops.mega_arrays(mega, dev)
        return K.mega_cuda_call(
            m["rec"], words, m["stage_table"], m["out_addrs"], m["out_rows"],
            n_addr=mega.n_addr, n_outputs=mega.n_outputs,
            chain=mega.mode == "chain", handoff_rows=m["handoff_rows"],
            plan=m["plan"])

    megas = {name: art.megaprogram() for name, art in arts.items()}
    for mega in megas.values():
        max_err["mega"] = max(max_err["mega"], word_err(
            mega_call(mega), ops.mega_forward_words(mega, words,
                                                    use_ref=True)))
    check(max_err == {"logic": 0, "mega": 0}, f"bit-exact: {max_err}")

    def bound(n_gates, stream_arrays, n_in, n_out):
        nbytes = sum(t.numel() * t.element_size() for t in stream_arrays) \
            + (n_in + n_out) * w * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_gates * w / int32_ops_per_s * 1e3
        return {"bytes": nbytes, "ops": n_gates * w,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def plan_info(plan, ms, steps):
        return {"scratch": plan.scratch, "block_cols": plan.cols,
                "ring": plan.ring, "one_barrier": plan.one_barrier,
                "smem_bytes": plan.smem_bytes, "steps": steps,
                "ms_per_step": ms / steps if steps else None}

    timing = {"phase": "timing", "batch": CAPACITY, "words": w,
              "reps": args.reps, "nvidia_smi": smi}
    a1 = ops.program_arrays(prog, dev)
    # "ms" is the device's busy time per call over 50 calls back to back
    # (profiler): at these sizes the host's cost per call exceeds the
    # kernel, so event times over back-to-back calls ("event_ms") measure
    # the host
    def times(fn, calls=50):
        return {"ms": device_ms_per_call(torch, fn, calls),
                "event_ms": cuda_ms(fn, args.reps)}

    t = times(k1)
    ms = t["ms"]
    timing["K1"] = {**t, "plain_ms": cuda_ms(k1_plain, 3, warmup=1),
                    **plan_info(a1["plan"], ms, prog.n_steps),
                    **bound(prog.n_gates, [a1["rec"], a1["output_addrs"]],
                            prog.n_inputs, prog.n_outputs)}
    for name, mega in megas.items():
        m = ops.mega_arrays(mega, dev)
        t = times(lambda: mega_call(mega))
        ms = t["ms"]
        timing[f"K2/{name}"] = {
            **t,
            "plain_ms": cuda_ms(lambda: ops.mega_forward_words(
                mega, words, use_ref=True), 3, warmup=1),
            **plan_info(m["plan"], ms, mega.total_steps),
            **bound(sum(p.n_gates for p in mega.stages), [m[k] for k in (
                "rec", "stage_table", "out_addrs", "out_rows")],
                mega.n_inputs, mega.n_outputs)}
    # the device-memory variant at the same batch, on the program past
    # shared memory
    big_words = ops.pack_bits(bits_on_card(rand_bits(CAPACITY,
                                                     big.n_inputs)))
    k1_big, _ = k1_calls(big, big_words)
    ab = ops.program_arrays(big, dev)
    t = times(k1_big, 10)
    ms = t["ms"]
    timing["K1/big_device"] = {
        **t, **plan_info(ab["plan"], ms, big.n_steps),
        **bound(big.n_gates, [ab["rec"], ab["output_addrs"]],
                big.n_inputs, big.n_outputs)}
    emit(timing)

    # wave time through the engine (one full-capacity request per wave),
    # and where one wave's time goes: CUDA events between the runner's
    # phases on an otherwise empty stream, so "launch+kernel" also holds
    # the wrapper's host work before the launch; the kernel's own device
    # time per wave comes from the profiler ("profiled")
    eng_out = {"phase": "engine", "capacity": CAPACITY,
               "waves_timed": TIMED_WAVES}
    slabs = [rand_bits(CAPACITY, FANIN) for _ in range(10)]
    for name, eng in engines.items():
        eng.serve(graph, slabs[0])                           # warm
        eng.reset_telemetry()
        times, outs = [], {}
        for i in range(TIMED_WAVES):
            t0 = time.perf_counter()
            outs[i % len(slabs)] = eng.serve(graph, slabs[i % len(slabs)])
            times.append(time.perf_counter() - t0)
        check(eng.stats()["invocations"] == TIMED_WAVES,
              f"{name}: one wave per full-capacity request")
        for i, out in outs.items():
            check(bool((out == arts[name].execute(slabs[i])).all()),
                  f"{name}: timed waves match the oracle")
        wave_ms = np.asarray(times) * 1e3
        eng_out[name] = {"wave_ms_p50": float(np.median(wave_ms)),
                         "wave_ms_p90": float(np.percentile(wave_ms, 90)),
                         "samples_per_s_p50": CAPACITY / float(
                             np.median(wave_ms)) * 1e3}
        phases = ("h2d", "pack", "launch+kernel", "unpack", "d2h")
        split = {k: [] for k in (*phases, "wall")}
        for i in range(20):
            slab = slabs[i % len(slabs)]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            t0 = time.perf_counter()
            ev[0].record()
            xb = torch.from_numpy(slab).to(dev)
            ev[1].record()
            wd = ops.pack_bits(xb)
            ev[2].record()
            ow = ops.mega_forward_words(megas[name], wd)
            ev[3].record()
            ub = ops.unpack_bits(ow, CAPACITY)
            ev[4].record()
            host = ub.cpu().numpy()
            ev[5].record()
            split["wall"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            for k, (a, b_) in zip(phases, zip(ev, ev[1:])):
                split[k].append(a.elapsed_time(b_))
            check(bool((host == outs[i % len(slabs)]).all()),
                  f"{name}: phased wave matches the engine")
        eng_out[name]["runner_split_ms_p50"] = {
            k: float(np.median(v)) for k, v in split.items()}
        eng_out[name]["profiled"] = profile_waves(
            torch, lambda: [eng.serve(graph, s) for s in slabs])
    emit(eng_out)
    sharded = sharded_serving_phase(torch, dev, smi, graph, engines,
                                    rand_bits)

    xnor = xnor_phase(args, torch, dev, cuda_ms, smi)
    flow = flow_phase(torch, dev)
    calib = calibrate_phase(torch, dev, smi, artifact, x_k1, k1_out,
                            k1_oracle)
    t0 = time.perf_counter()
    frng = np.random.default_rng(args.seed + 1)
    W2 = frng.normal(size=(NEURONS, FC2_NEURONS))
    b2 = 0.1 * frng.normal(size=FC2_NEURONS)
    x_isf2 = frng.integers(0, 2, (ISF_SAMPLES, NEURONS)).astype(np.uint8)
    fc2 = layer_to_graph(x_isf2, W2, b2, mode="isf", name="lenet5_fc2")
    fc2_synth_s = time.perf_counter() - t0
    check(fc2.n_inputs == NEURONS and fc2.n_outputs == FC2_NEURONS,
          "fc2 graph is NEURONS -> FC2_NEURONS")
    tenants = {"fc1": graph, "fc2": fc2}
    door = frontdoor_phase(args, torch, dev, smi, tenants, fc2_synth_s)
    warm = warm_start_phase(args, smi, tenants,
                            door["cold_first_request_s"])
    quick = quickstart_phase(torch, dev, smi)
    lffn = logic_ffn_phase(args, torch, dev, smi, cuda_ms)
    lm_phase(args, torch, dev, smi)
    full = train_full_phase(args, torch, dev, smi)
    dryrun_phase(smi, full)
    train_parity_phase(args, torch, dev, smi)
    sharded_train_phase(args, torch, dev, smi, full)
    lswap = logic_swap_train_phase(args, torch, dev, smi, cuda_ms)
    families_phase(args, torch, dev, smi)
    train_families_phase(args, torch, dev, smi)
    max_err["logic"] = max(max_err["logic"], quick["max_abs_err"],
                           lffn["max_abs_err"], lswap["max_abs_err"])
    paths = {"fc1": launches, "xnor": xnor["launches"],
             "flow": flow["launches"], "flow_default": flow["default"]["launches"],
             "calibrate": calib["launches"], "frontdoor": door["launches"],
             "warm_start": warm["launches"], "quickstart": quick["launches"],
             "logic_ffn": lffn["launches"],
             "logic_swap_train": lswap["launches"],
             "sharded_serving": sharded["launches"]}
    check(xnor["launches"]["xnor"] == len(XNOR_SHAPES),
          "xnor_gemm made one K3 launch per full-width call")

    def path_launches(kind):
        return {k: v[kind] for k, v in paths.items() if v.get(kind)}

    vgg = xnor["timing"]["vgg16_conv6"]
    kernels = [
        {"name": "mega_kernel, one stage (K1)", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": K1_REPLACES,
         "launches": sum(path_launches("logic").values()),
         "launches_by_path": path_launches("logic"),
         "max_abs_err": max_err["logic"],
         "ms": timing["K1"]["ms"], "event_ms": timing["K1"]["event_ms"],
         "plain_ms": timing["K1"]["plain_ms"],
         "bound_ms": timing["K1"]["bound_ms"],
         "bound_by": timing["K1"]["bound_by"], "library_ms": None,
         "scratch": timing["K1"]["scratch"],
         "ms_per_step": timing["K1"]["ms_per_step"]},
        {"name": "mega_kernel (K2)", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": K2_REPLACES,
         "launches": sum(path_launches("mega").values()),
         "launches_by_path": path_launches("mega"),
         "max_abs_err": max_err["mega"],
         "ms": timing["K2/monolithic"]["ms"],
         "event_ms": timing["K2/monolithic"]["event_ms"],
         "plain_ms": timing["K2/monolithic"]["plain_ms"],
         "bound_ms": timing["K2/monolithic"]["bound_ms"],
         "bound_by": timing["K2/monolithic"]["bound_by"],
         "library_ms": None, "scratch": timing["K2/monolithic"]["scratch"],
         "ms_per_step": timing["K2/monolithic"]["ms_per_step"],
         "parallel4": {k: timing["K2/parallel4"][k] for k in (
             "ms", "bound_ms", "scratch", "ms_per_step")},
         "device_variant": {k: timing["K1/big_device"][k] for k in (
             "ms", "bound_ms", "scratch", "ms_per_step")}},
        {"name": "xnor_kernel (K3)", "route": "cuda", "source": K3_SOURCE,
         "instruction": K3_ROUTE,
         "tensor_core_sass": sum(xnor_sass.values()),
         "replaces": K3_REPLACES,
         "launches": sum(path_launches("xnor").values()),
         "launches_by_path": path_launches("xnor"),
         "max_abs_err": xnor["max_abs_err"], "at": "vgg16_conv6",
         "ms": vgg["device_ms"], "event_ms": vgg["ms"],
         "plain_ms": vgg["plain_ms"],
         "bound_ms": vgg["bound_ms"], "bound_by": vgg["bound_by"],
         "library_ms": vgg["library_device_ms"],
         "library_event_ms": vgg["library_ms"],
         "lenet5_fc1": {k: xnor["timing"]["lenet5_fc1"][k] for k in (
             "device_ms", "bound_ms", "library_device_ms")}},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def sharded_serving_phase(torch, dev, smi, graph, engines,
                          rand_bits) -> dict:
    """The engine's split path (the reference's ``shard_map`` over a
    1-axis mesh) on the one card: fc1 and its 4-program pipeline served by
    ``LogicEngine(shard=True)`` on ``cuda:0`` and by
    ``LogicEngine(devices=[cuda:0, cuda:0])`` (two shards, each on its own
    stream), sharing the unsharded engines' caches, over the main path's
    ragged requests plus full-capacity slabs.  Gated: every output equal
    to the numpy oracle and to the unsharded engine; one K2 launch a shard
    a wave, all on the shared variant; ``stats()`` reporting the devices
    and the split; a capacity of 8,190 rounded up to the two shards'
    64-row quantum and served exactly.  Reported: the wave p50 / p90,
    unsharded, one shard and two shards, and the visible card count."""
    import numpy as np

    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.serve import LogicEngine

    sizes = (1, 33, 700, 4096, 8192, 10000)
    inputs = [rand_bits(n, FANIN) for n in sizes] + [
        rand_bits(CAPACITY, FANIN) for _ in range(SHARD_SLABS)]
    slabs = inputs[len(sizes):]
    arts = {name: artifact_of(eng) for name, eng in engines.items()}
    t0 = time.perf_counter()
    oracle = {name: [art.execute(x) for x in inputs]
              for name, art in arts.items()}
    oracle_s = time.perf_counter() - t0
    unsharded = {name: [eng.serve(graph, x) for x in inputs]
                 for name, eng in engines.items()}
    layouts = {"one_shard": dict(device=dev, shard=True),
               "two_shards": dict(devices=[dev, dev])}
    shards = {"one_shard": 1, "two_shards": 2}
    runs = {(name, label): LogicEngine(eng.spec, capacity=CAPACITY,
                                       cache=eng.cache, **kw)
            for name, eng in engines.items()
            for label, kw in layouts.items()}
    odd = LogicEngine(engines["monolithic"].spec, capacity=CAPACITY - 2,
                      devices=[dev, dev], cache=engines["monolithic"].cache)
    x_odd = rand_bits(CAPACITY - 2, FANIN)

    K.reset_launch_counts()                 # sharded path starts here
    per = {}
    for (name, label), eng in runs.items():
        before = K.launch_count("mega")
        uids = [eng.submit(graph, x) for x in inputs]
        eng.drain()
        torch.cuda.synchronize()
        outs = [eng.result(u) for u in uids]
        st = eng.stats()
        per[f"{name}/{label}"] = {
            "shards": shards[label], "waves": st["invocations"],
            "k2_launches": K.launch_count("mega") - before,
            "n_devices": st["n_devices"], "sharded": st["sharded"],
            "capacity": st["capacity"],
            "exact_vs_oracle": all(bool((o == w).all()) for o, w in
                                   zip(outs, oracle[name])),
            "exact_vs_unsharded": all(bool((o == w).all()) for o, w in
                                      zip(outs, unsharded[name]))}
    before = K.launch_count("mega")
    got_odd = odd.serve(graph, x_odd)
    torch.cuda.synchronize()
    odd_out = {"asked": CAPACITY - 2, "capacity": odd.capacity,
               "k2_launches": K.launch_count("mega") - before,
               "stats": {k: odd.stats()[k] for k in ("n_devices",
                                                     "sharded")},
               "exact_vs_oracle": bool((got_odd == arts["monolithic"]
                                        .execute(x_odd)).all())}
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    by_variant = variant_counts(K)          # sharded path ends here

    timed = {}
    for label, eng in (("unsharded", engines["monolithic"]),
                       ("one_shard", runs["monolithic", "one_shard"]),
                       ("two_shards", runs["monolithic", "two_shards"])):
        eng.serve(graph, slabs[0])                          # warm
        times, same = [], True
        for i in range(SHARD_TIMED_WAVES):
            t1 = time.perf_counter()
            o = eng.serve(graph, slabs[i % len(slabs)])
            times.append(time.perf_counter() - t1)
            same &= bool((o == unsharded["monolithic"][
                len(sizes) + i % len(slabs)]).all())
        ms = np.asarray(times) * 1e3
        timed[label] = {"wave_ms_p50": float(np.median(ms)),
                        "wave_ms_p90": float(np.percentile(ms, 90)),
                        "exact": same}
    out = {"phase": "sharded_serving", "nvidia_smi": smi,
           "device_count": torch.cuda.device_count(),
           "capacity": CAPACITY, "requests": list(sizes),
           "slabs": SHARD_SLABS, "runs": per, "odd_capacity": odd_out,
           "launches": launches, "launches_by_variant": by_variant,
           "timed_waves": SHARD_TIMED_WAVES, "wave_ms": timed,
           "oracle_s": oracle_s}
    emit(out)
    for key, r in per.items():
        check(r["exact_vs_oracle"] and r["exact_vs_unsharded"],
              f"sharded_serving {key}: every output equals the oracle and "
              "the unsharded engine")
        check(r["waves"] > 0 and r["k2_launches"] == r["shards"] *
              r["waves"], f"sharded_serving {key}: one K2 launch a shard a "
              f"wave ({r['k2_launches']} vs {r['shards']} x {r['waves']})")
        check(r["n_devices"] == r["shards"] and r["sharded"],
              f"sharded_serving {key}: stats report the split: {r}")
    check(odd_out["capacity"] == CAPACITY and odd_out["exact_vs_oracle"]
          and odd_out["k2_launches"] == 2 and
          odd_out["stats"] == {"n_devices": 2, "sharded": True},
          f"sharded_serving: capacity {CAPACITY - 2} rounds up to the "
          f"64-row quantum and serves exactly: {odd_out}")
    check(launches["mega"] == sum(r["k2_launches"] for r in per.values())
          + odd_out["k2_launches"] and launches["logic"] == 0 and
          by_variant["mega/shared"] == launches["mega"],
          f"sharded_serving: every launch is a shared-variant K2 launch: "
          f"{launches} {by_variant}")
    check(all(v["exact"] for v in timed.values()),
          "sharded_serving: the timed waves equal the unsharded engine's")
    return out


def xnor_phase(args, torch, dev, cuda_ms, smi) -> dict:
    """K3: bit-exact against its plain version on the reference test's
    shapes and ragged ones (row 0 of A all ones, so words with bit 31 set),
    then ``xnor_gemm`` at the full-width shapes as the main path, each
    output exact against ``torch._int_mm`` on the +-1 int8 operands, then
    the kernel, its plain version and ``_int_mm`` timed there."""
    import numpy as np

    from repro_torch.kernels.xnor_gemm import (kernel as K3, pack_pm1,
                                               xnor_gemm, xnor_packed_ref)

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 3)

    def operands(m, n, k):
        a = torch.from_numpy(rng.integers(0, 2, (m, k), dtype=np.uint8)).to(dev)
        b = torch.from_numpy(rng.integers(0, 2, (n, k), dtype=np.uint8)).to(dev)
        a[0] = 1
        return a, b

    def err(x, y) -> int:
        return int((x.long() - y.long()).abs().max()) if x.numel() else 0

    max_err, failures = 0, []
    for m, n, k in XNOR_PARITY:
        a, b = operands(m, n, k)
        ap, bp = pack_pm1(a), pack_pm1(b)
        e = err(K3.xnor_cuda_call(ap, bp, k), xnor_packed_ref(ap, bp, k))
        torch.cuda.synchronize()
        max_err = max(max_err, e)
        if e:
            failures.append(f"{m}x{n}x{k}")
    parity_s = time.perf_counter() - t0

    full = {name: operands(*shape) for name, shape in XNOR_SHAPES.items()}
    K3.reset_launch_counts()                    # main path starts here
    outs = {name: xnor_gemm(a, b, device=dev) for name, (a, b) in full.items()}
    torch.cuda.synchronize()
    launches = {"xnor": K3.launch_count("xnor")}  # main path ends here

    timing = {}
    for name, (m, n, k) in XNOR_SHAPES.items():
        a, b = full[name]
        ap, bp = pack_pm1(a), pack_pm1(b)
        a8 = (2 * a.to(torch.int8) - 1).contiguous()
        b8t = (2 * b.to(torch.int8) - 1).contiguous().t()
        lib = torch._int_mm(a8, b8t)
        plain = xnor_packed_ref(ap, bp, k)
        torch.cuda.synchronize()
        check(outs[name].shape == (m, n), f"xnor {name}: output shape")
        e = max(err(outs[name], plain), err(outs[name], lib))
        max_err = max(max_err, e)
        check(e == 0, f"xnor {name}: K3 == plain == _int_mm")
        kw = ap.shape[1]
        nbytes = (m * kw + n * kw + m * n) * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / PM1_OPS_PER_S * 1e3
        timing[name] = {
            "m": m, "n": n, "k": k, "kw": kw,
            "ms": cuda_ms(lambda: K3.xnor_cuda_call(ap, bp, k), args.reps),
            "plain_ms": cuda_ms(lambda: xnor_packed_ref(ap, bp, k), 3,
                                warmup=1),
            "library_ms": cuda_ms(lambda: torch._int_mm(a8, b8t), args.reps),
            "device_ms": device_ms_per_call(
                torch, lambda: K3.xnor_cuda_call(ap, bp, k), 50),
            "library_device_ms": device_ms_per_call(
                torch, lambda: torch._int_mm(a8, b8t), 50),
            "bytes": nbytes, "ops": 2 * m * n * k,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    out = {"phase": "xnor", "parity_cases": len(XNOR_PARITY),
           "failures": failures, "tolerance": 0, "max_abs_err": max_err,
           "parity_s": parity_s, "launches": launches,
           "library": "torch._int_mm on the +-1 int8 operands",
           "int8_ops_per_s": INT8_OPS_PER_S, "route": K3_ROUTE,
           "route_ops_per_s": B1_MMA_OPS_PER_S,
           "bound_ops_per_s": PM1_OPS_PER_S,
           "reps": args.reps, "nvidia_smi": smi,
           "timing": timing}
    emit(out)
    check(not failures and max_err == 0, f"K3 parity failed: {failures}")
    return out


def flow_phase(torch, dev) -> dict:
    """The NullaNet flow on the card: ``run_flow`` at LeNet-5's FC widths
    (ISF conversion, all four backends, an engine of one full wave), then
    the default exact configuration.  Launches are counted over each
    ``run_flow`` call alone."""
    from repro_torch.core.spec import CompileSpec
    from repro_torch.flow import BACKENDS, FlowConfig, run_flow
    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.serve import LogicEngine

    n = FLOW_TRAIN + FLOW_VAL
    cfg = FlowConfig(**FLOW_WIDTHS, n_samples=n, val_frac=FLOW_VAL / n,
                     noise=0.05, train_steps=300, seed=0,
                     spec=CompileSpec(n_unit=256), mode="auto")
    check(not cfg.exact and cfg.backends == BACKENDS,
          "LeNet-5 widths convert by ISF through all four backends")
    engine = LogicEngine(cfg.spec, capacity=CAPACITY, device=dev)
    t0 = time.perf_counter()
    K.reset_launch_counts()                     # flow path starts here
    report, _ = run_flow(cfg, device=dev, engine=engine)
    torch.cuda.synchronize()
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    wall_s = time.perf_counter() - t0           # flow path ends here
    by_variant = variant_counts(K)
    waves = engine.stats()["invocations"]
    out = {"phase": "flow",
           "model": "binarized MLP at LeNet-5's FC widths ("
                    + " -> ".join(map(str, (cfg.n_features, *cfg.hidden,
                                            cfg.n_classes))) + ")",
           **summary(report), "wall_s": wall_s, "engine_waves": waves,
           "launches": launches, "launches_by_variant": by_variant}

    K.reset_launch_counts()                     # default flow starts here
    default, _ = run_flow(FlowConfig(), device=dev)
    torch.cuda.synchronize()
    out["default"] = {
        "model": "FlowConfig() (12 -> 10 -> 8 -> 4, enumerated)",
        **summary(default),
        "launches": {k: K.launch_count(k) for k in ("logic", "mega",
                                                     "xnor")},
        "launches_by_variant": variant_counts(K)}
    emit(out)
    for v in (by_variant, out["default"]["launches_by_variant"]):
        check(v["logic/device"] == 0 and v["mega/device"] == 0,
              f"the flow's small programs took the shared variant: {v}")
    check(report.n_train == FLOW_TRAIN and report.n_val == FLOW_VAL,
          f"flow split is {FLOW_TRAIN} / {FLOW_VAL}")
    check(report.bit_identical, "flow backends bit-identical")
    check(launches["logic"] == len(cfg.hidden), "one K1 launch per layer")
    check(waves == 1 and launches["mega"] == 1 + waves,
          "one K2 launch for the megakernel, one per engine wave")
    check(out["default"]["launches"]["logic"] == 2 and
          out["default"]["launches"]["mega"] > 1,
          "default flow launched K1 per layer and K2")
    check(default.exact_mode and default.parity and default.bit_identical,
          "default flow: exact parity, bit-identical backends")
    return out


def summary(report) -> dict:
    return {"float_acc": report.float_acc,
            "binarized_acc": report.binarized_acc,
            "logic_acc": report.logic_acc, "parity": report.parity,
            "bit_identical": report.bit_identical,
            "exact_mode": report.exact_mode,
            "eval_ms": {k: v * 1e3 for k, v in report.eval_s.items()},
            "train_s": report.train_s, "convert_s": report.convert_s,
            "layers": [{k: st[k] for k in ("name", "n_inputs", "n_outputs",
                                           "n_gates", "n_steps", "depth")}
                       for st in report.layers],
            "n_train": report.n_train, "n_val": report.n_val}


def calibrate_phase(torch, dev, smi, artifact, x, fused, oracle) -> dict:
    """The calibration phase path on the card: ``collect_probes`` over the
    quick probe grid (15 programs, each through ``phased_infer_bits``, one
    K1 launch a call), the fit saved to a store as this device's record and
    loaded back in a fresh process with no re-fit; then the phase path on
    fc1's program against the fused path and the oracle, and the ``n_unit``
    the fit picks for fc1 (reported, not gated: it moves with timing
    noise).  Launches are counted over the probes and those three calls."""
    from repro_torch.core import calibrate
    from repro_torch.core.artifact_store import ArtifactStore
    from repro_torch.core.compiler import LogicCompiler
    from repro_torch.core.spec import CompileSpec
    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.kernels.logic_dsp import ops
    from repro_torch.tools import calibrate as calibrate_tool

    graphs = calibrate.default_probe_graphs(quick=True)
    units = calibrate.default_probe_units(quick=True)
    prog = artifact.program
    t0 = time.perf_counter()
    K.reset_launch_counts()                     # calibrate path starts here
    probes = calibrate.collect_probes(graphs, units,
                                      n_input_vectors=CAL_BATCH,
                                      reps=CAL_REPS, device=dev)
    collect_s = time.perf_counter() - t0
    phased, phases = ops.phased_infer_bits(prog, x, device=dev)
    fused_again = ops.logic_infer_bits(prog, x, device=dev)
    with calibrate.PhaseTimer() as timer:
        timed = ops.logic_infer_bits(prog, x, device=dev)
    torch.cuda.synchronize()
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    # calibrate path ends here
    cal = calibrate.fit_calibration(probes, meta={
        "grid": "quick", "device": torch.cuda.get_device_name(0),
        "reps": CAL_REPS, "batch": CAL_BATCH, "n_probes": len(probes)})
    name = ops.calibration_name(dev)
    with tempfile.TemporaryDirectory(prefix="calibrate_",
                                     dir=scratch_dir()) as d:
        path = ArtifactStore(d).save_calibration(cal, name=name)
        record = path.name
        proc = calibrate_tool.verify(d, name, "cuda")
    t1 = time.perf_counter()
    pick, search = LogicCompiler(calibration=cal).resolve(
        artifact.graph, CompileSpec(n_unit="auto", objective="wallclock"),
        assume_optimized=True)
    pick_s = time.perf_counter() - t1
    fits = {p: {"coefs": list(f.coefs), "offset": f.offset,
                "median_abs_rel_err": f.median_abs_rel_err}
            for p, f in cal.fits.items()}
    exact = {"phased_vs_fused": bool((phased == fused).all()),
             "phased_vs_fused_again": bool((phased == fused_again).all()),
             "timer_routed_vs_fused": bool((timed == fused).all()),
             "phased_vs_oracle": bool((phased == oracle).all())}
    out = {"phase": "calibrate", "nvidia_smi": smi, "programs": len(probes),
           "grid": {"graphs": {k: g.n_gates for k, g in graphs.items()},
                    "n_units": list(units), "batch": CAL_BATCH,
                    "reps": CAL_REPS},
           "collect_s": collect_s, "record": record,
           "fresh_process": {"rc": proc.returncode,
                             "stdout": proc.stdout.strip()[-300:],
                             "stderr": proc.stderr.strip()[-600:]},
           "median_abs_rel_err": cal.median_abs_rel_err(), "fits": fits,
           "fc1_phases_ms": {p: v * 1e3 for p, v in phases.items()},
           "timer_samples": len(timer.samples), "exact": exact,
           "fc1_wallclock_pick": pick.n_unit,
           "fc1_cycles_pick": search.alt.best_n_unit
           if search.alt is not None else None,
           "fc1_main_path_n_unit": prog.n_unit, "pick_s": pick_s,
           "launches": launches}
    emit(out)
    check(len(probes) == len(graphs) * len(units) == 15,
          "the quick grid is 15 programs")
    check(all(math.isfinite(v) and v >= 0.0 for f in cal.fits.values()
              for v in (*f.coefs, f.offset)),
          "the fit's coefficients are finite and non-negative")
    check(record == "torch-cuda.json", "the fit is saved as torch-cuda")
    check(proc.returncode == 0 and "zero re-fits" in proc.stdout,
          f"a fresh process loads the fit with no re-fit: {proc.stderr}")
    check(all(exact.values()), f"the phase path is bit-exact: {exact}")
    check(len(timer.samples) == 1 and
          timer.samples[0]["meta"]["backend"] == "cuda",
          "logic_infer_bits took the phase path under a PhaseTimer")
    check(launches["logic"] == len(probes) * (1 + CAL_REPS) + 3 and
          launches["mega"] == 0,
          f"one K1 launch per phased call, no K2: {launches}")
    return out


async def drive_trace(door, trace, payloads) -> dict:
    """Submit each request of ``trace`` through ``door.submit`` at its
    trace time (its payload drawn beforehand), await every outcome, and
    record offered, completions with their latencies and bits, sheds by
    code, and when the first and the last request went in."""
    import asyncio

    from repro_torch.serve import RequestRejected

    res = {"offered": len(trace), "completed": 0, "shed_by_code": {},
           "deadline_missed": 0, "goodput_samples": 0, "latencies_s": [],
           "served": []}

    async def issue(req, bits):
        t0 = time.monotonic()
        try:
            out = await door.submit(req.tenant, bits,
                                    deadline_s=req.deadline_s,
                                    priority=req.priority)
        except RequestRejected as exc:
            code = exc.reason.code
            res["shed_by_code"][code] = res["shed_by_code"].get(code, 0) + 1
            return
        latency = time.monotonic() - t0
        res["completed"] += 1
        res["latencies_s"].append(latency)
        res["served"].append((req.tenant, bits, out))
        if latency > req.deadline_s:
            res["deadline_missed"] += 1
        else:
            res["goodput_samples"] += len(bits)

    # the trace's clock starts at its first arrival, which goes in at once
    tasks, sent = [], []
    start = time.monotonic() - trace[0].t
    for req, bits in zip(trace, payloads):
        delay = start + req.t - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        sent.append(time.monotonic())
        tasks.append(asyncio.create_task(issue(req, bits)))
    await asyncio.gather(*tasks)
    res["elapsed_s"] = time.monotonic() - sent[0]
    res["offered_span_s"] = sent[-1] - sent[0]
    res["trace_span_s"] = trace[-1].t - trace[0].t
    return res


def trace_summary(res: dict, waves: int, deadline_s: float) -> dict:
    """What one trace's run reports (everything but the served bits)."""
    import numpy as np

    lat = np.asarray(res["latencies_s"]) * 1e3
    shed = sum(res["shed_by_code"].values())
    return {"offered": res["offered"], "completed": res["completed"],
            "shed": shed, "shed_rate": shed / max(1, res["offered"]),
            "shed_by_code": dict(res["shed_by_code"]),
            "shed_rate_by_code": {c: n / max(1, res["offered"])
                                  for c, n in res["shed_by_code"].items()},
            "deadline_s": deadline_s,
            "deadline_missed": res["deadline_missed"],
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            "goodput_samples_per_s": res["goodput_samples"] /
            res["elapsed_s"],
            "elapsed_s": res["elapsed_s"],
            "trace_span_s": res["trace_span_s"],
            "offered_span_s": res["offered_span_s"],
            "waves": waves,
            "requests_per_wave": res["completed"] / max(1, waves)}


def frontdoor_phase(args, torch, dev, smi, tenants, fc2_synth_s) -> dict:
    """The front door on the card: two tenants (fc1, fc2) behind one
    ``FrontDoor`` at capacity 8192 with an artifact store.  Load points
    come from measurements: L, one mean-size request's latency alone; a
    light Poisson trace at ``FD_LIGHT_LOAD / L``; R_sat, the closed-loop
    completion rate at every tenant's inflight cap; a Poisson overload at
    ``FD_OVERLOAD x R_sat`` with a seeded FaultPolicy (drops, delays);
    last the reference's own 2x point (``two_x``: unloaded p99 from
    sequential requests, 2 x capacity / wave / 24 requests a second,
    eviction and delay faults) with its bound 3 x unloaded p99 + 75 ms
    reported as held or not.  Between the first traces each tenant's
    program is evicted and reloaded from the store.  Gated: bit-exact
    results, every request accounted for, known shed codes, paced light
    and overload traces, the light trace's sheds, the overload's sheds and
    injected drops, one K2 launch per wave, reloads with no compile.
    Timings (latencies, the 2x bound, idle share) are reported, not
    gated."""
    import asyncio

    import numpy as np

    from repro_torch.core.artifact_store import ArtifactStore
    from repro_torch.core.spec import CompileSpec
    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.serve import (SHED_CODES, FaultPolicy, FrontDoor,
                                   TrafficPattern, build_trace)

    rng = np.random.default_rng(args.seed + 5)
    names = list(tenants)

    def draw(name, n):
        return rng.integers(0, 2, (n, tenants[name].n_inputs)).astype(bool)

    def payloads(trace):
        return [draw(r.tenant, r.n_samples) for r in trace]

    def pattern(name, rate, n):
        return TrafficPattern(tenant=name, rate_rps=rate, n_requests=n,
                              size_mean=FD_SIZE_MEAN, size_max=FD_SIZE_MAX,
                              deadline_s=FD_DEADLINE_S)

    async def profiled(coro):
        """Await ``coro`` under torch.profiler: its result plus wall time,
        host CPU share and the device's busy time and idle share."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0, c0 = time.perf_counter(), time.process_time()
            res = await coro
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cpu = time.process_time() - c0
        busy_us, by_name = device_busy(prof)
        return res, {"wall_s": wall, "host_cpu_share": cpu / wall,
                     "device_busy_ms": None if busy_us is None
                     else busy_us / 1e3,
                     "device_idle_share": None if busy_us is None
                     else 1 - busy_us / 1e6 / wall,
                     "device_ms_by_name": dict(by_name[:5])}

    async def sequential(door, n):
        """``n`` mean-size requests one after another, tenants in turn:
        their latencies (s) and what they served."""
        lat, served = [], []
        for i in range(n):
            name = names[i % len(names)]
            bits = draw(name, FD_SIZE_MEAN)
            t0 = time.perf_counter()
            out = await door.submit(name, bits, deadline_s=60.0)
            lat.append(time.perf_counter() - t0)
            served.append((name, bits, out))
        return lat, served

    async def reload(door, served):
        """Evict each tenant's program and submit again: the entry must
        come back from the store, with no compile."""
        cache, out = door.engine.cache, {}
        for name in names:
            before = cache.stats()
            key = cache.get(tenants[name], door.engine.spec).key
            check(cache.evict(key) == key, f"{name}: evicted")
            bits = draw(name, FD_SIZE_MEAN)
            t0 = time.perf_counter()
            y = await door.submit(name, bits, deadline_s=60.0)
            dt = time.perf_counter() - t0
            served.append((name, bits, y))
            after = cache.stats()
            out[name] = {"reload_ms": dt * 1e3,
                         "compiles": after["compiles"] - before["compiles"],
                         "store_hits": after["store_hits"] -
                         before["store_hits"]}
        return out

    async def saturate(door, served):
        """Closed loop: every tenant keeps FD_MAX_INFLIGHT mean-size
        requests outstanding for FD_SAT_S; completions per second."""
        done, t_end = [0], time.monotonic() + FD_SAT_S
        pools = {n: [draw(n, FD_SIZE_MEAN) for _ in range(64)]
                 for n in names}

        async def worker(name, k):
            i = k
            while time.monotonic() < t_end:
                bits = pools[name][i % len(pools[name])]
                i += FD_MAX_INFLIGHT
                y = await door.submit(name, bits, deadline_s=60.0)
                served.append((name, bits, y))
                done[0] += 1

        w0 = door.engine.invocations
        t0 = time.monotonic()
        await asyncio.gather(*(worker(n, k) for n in names
                               for k in range(FD_MAX_INFLIGHT)))
        elapsed = time.monotonic() - t0
        waves = door.engine.invocations - w0
        return {"completed": done[0], "elapsed_s": elapsed,
                "r_sat_rps": done[0] / elapsed, "waves": waves,
                "requests_per_wave": done[0] / max(1, waves)}

    async def two_x_point(door, served):
        """The reference's graceful-degradation point: the unloaded p99 of
        sequential mean-size requests (the door's own latency window),
        then 2 x the sustainable rate (capacity / wave / mean size) split
        over a Poisson and a Pareto tenant under eviction and delay
        faults, and the bound 3 x unloaded p99 + 75 ms (reported)."""
        door.reset_metrics()
        _, seq = await sequential(door, FD2X_SEQUENTIAL)
        served += seq
        unloaded_p99 = door.metrics()["latency_p99_ms"]
        door.reset_metrics()
        wave = door.wave_s
        check(wave is not None and wave > 0, "the door measured its wave")
        sustainable = CAPACITY / max(wave, 1e-4) / FD_SIZE_MEAN
        rate = 2.0 * sustainable / len(names)
        arrivals = dict(zip(names, ("poisson", "pareto")))
        trace = build_trace([TrafficPattern(
            tenant=n, rate_rps=rate, n_requests=FD2X_REQUESTS,
            arrival=arrivals[n], pareto_alpha=1.5, size_mean=FD_SIZE_MEAN,
            size_max=FD2X_SIZE_MAX, deadline_s=FD2X_DEADLINE_S)
            for n in names], seed=args.seed + 17)
        trace_bits = payloads(trace)
        policy = FaultPolicy(**FD2X_FAULTS)
        door.fault_policy = policy
        w0 = door.engine.invocations
        res, prof = await profiled(drive_trace(door, trace, trace_bits))
        door.fault_policy = None
        summ = trace_summary(res, door.engine.invocations - w0,
                             FD2X_DEADLINE_S)
        bound = 3.0 * unloaded_p99 + 75.0
        return {**summ, "unloaded_p99_ms": unloaded_p99,
                "wave_ms": wave * 1e3, "sustainable_rps": sustainable,
                "rate_rps": 2.0 * sustainable, "faults": dict(FD2X_FAULTS),
                "injected": dict(policy.injected), "bound_ms": bound,
                "bound_held": (None if summ["p99_ms"] is None
                               else summ["p99_ms"] <= bound),
                "gated": False, **prof}, res

    async def go(store_dir):
        served = []
        out = {}
        door = FrontDoor(spec=CompileSpec(n_unit=256), capacity=CAPACITY,
                         store=ArtifactStore(store_dir),
                         default_deadline_s=FD_DEADLINE_S, device=dev)
        for name in names:
            door.register(name, tenants[name], max_inflight=FD_MAX_INFLIGHT)
        async with door:
            cold = {}
            for name in names:          # compile + write-through
                bits = draw(name, FD_SIZE_MEAN)
                t0 = time.perf_counter()
                y = await door.submit(name, bits, deadline_s=600.0)
                cold[name] = time.perf_counter() - t0
                served.append((name, bits, y))
            out["cold_first_request_s"] = cold
            _, warm_served = await sequential(door, 20)    # warm-up
            served += warm_served
            lat, seq_served = await sequential(door, 40)
            served += seq_served
            L = float(np.median(lat))
            out["L_ms"] = L * 1e3
            out["store_after_cold"] = door.engine.cache.stats()

            light = build_trace([pattern(n, FD_LIGHT_LOAD / L / len(names),
                                         FD_LIGHT_REQUESTS // len(names))
                                 for n in names], seed=args.seed + 11)
            light_bits = payloads(light)
            w0 = door.engine.invocations
            res, prof = await profiled(drive_trace(door, light, light_bits))
            out["light"] = {**trace_summary(res,
                                            door.engine.invocations - w0,
                                            FD_DEADLINE_S),
                            "rate_rps": FD_LIGHT_LOAD / L, **prof}
            out["light_raw"] = res
            out["reload_after_light"] = await reload(door, served)

            out["saturated"] = await saturate(door, served)
            out["reload_after_saturated"] = await reload(door, served)

            r_sat = out["saturated"]["r_sat_rps"]
            over = build_trace([pattern(n, FD_OVERLOAD * r_sat / len(names),
                                        FD_OVERLOAD_REQUESTS // len(names))
                                for n in names], seed=args.seed + 13)
            over_bits = payloads(over)
            policy = FaultPolicy(**FD_FAULTS)
            door.fault_policy = policy
            w0 = door.engine.invocations
            res, prof = await profiled(drive_trace(door, over, over_bits))
            door.fault_policy = None
            out["overload"] = {**trace_summary(res,
                                               door.engine.invocations - w0,
                                               FD_DEADLINE_S),
                               "rate_rps": FD_OVERLOAD * r_sat,
                               "faults": dict(FD_FAULTS),
                               "injected": dict(policy.injected), **prof}
            out["overload_raw"] = res
            out["two_x"], out["two_x_raw"] = await two_x_point(door, served)
        out["served"] = served
        out["waves"] = door.engine.invocations
        out["cache"] = door.engine.cache.stats()
        out["door_metrics"] = {k: v for k, v in door.metrics().items()
                               if k != "engine"}
        return out

    t0 = time.perf_counter()
    K.reset_launch_counts()                     # front-door path starts here
    with tempfile.TemporaryDirectory(prefix="frontdoor_",
                                     dir=scratch_dir()) as d:
        r = asyncio.run(go(d))
    torch.cuda.synchronize()
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    # front-door path ends here
    wall_s = time.perf_counter() - t0
    raws = [r.pop(k) for k in ("light_raw", "overload_raw", "two_x_raw")]
    served = r.pop("served") + [x for raw in raws for x in raw["served"]]
    t1 = time.perf_counter()
    by_tenant = {}
    for name, bits, y in served:
        by_tenant.setdefault(name, []).append((bits, y))
    exact = {}
    for name, items in by_tenant.items():
        x = np.concatenate([b for b, _ in items])
        y = np.concatenate([o for _, o in items])
        exact[name] = all(
            bool((tenants[name].evaluate(x[lo:lo + 4096]) ==
                  y[lo:lo + 4096]).all()) for lo in range(0, len(x), 4096))
    oracle_s = time.perf_counter() - t1
    out = {"phase": "frontdoor", "nvidia_smi": smi,
           "tenants": {n: {"inputs": g.n_inputs, "outputs": g.n_outputs,
                           "gates": g.n_gates} for n, g in tenants.items()},
           "fc2_synth_s": fc2_synth_s, "capacity": CAPACITY,
           "max_inflight": FD_MAX_INFLIGHT, "size_mean": FD_SIZE_MEAN,
           **r, "results_checked": len(served), "exact": exact,
           "oracle_s": oracle_s, "wall_s": wall_s, "launches": launches}
    emit(out)
    check(all(exact.values()), f"every served result is bit-exact: {exact}")
    for trace in ("light", "overload", "two_x"):
        t = out[trace]
        check(t["completed"] + t["shed"] == t["offered"],
              f"{trace}: completed + shed == offered")
        check(all(c in SHED_CODES for c in t["shed_by_code"]),
              f"{trace}: every shed code is known: {t['shed_by_code']}")
    for trace in ("light", "overload"):
        t = out[trace]
        check(t["offered_span_s"] >= 0.8 * t["trace_span_s"],
              f"{trace}: the trace was paced ({t['offered_span_s']:.3f} s "
              f"offered over a {t['trace_span_s']:.3f} s trace)")
    light, over = out["light"], out["overload"]
    check(light["offered"] >= 400 and over["offered"] >= 1200,
          "the traces offer 400 and 1200 requests")
    check(light["shed"] <= 0.01 * light["offered"],
          f"the light trace sheds at most 1%: {light['shed_by_code']}")
    check(over["shed"] > 0, "the overload sheds")
    check(over["shed_by_code"].get("injected_drop", 0) ==
          over["injected"]["drop"],
          "every injected drop is shed as injected_drop")
    check(launches["mega"] == out["waves"] > 0 and launches["logic"] == 0,
          f"one K2 launch per wave ({launches['mega']} launches, "
          f"{out['waves']} waves), no K1 launch")
    for when in ("reload_after_light", "reload_after_saturated"):
        for name, rl in out[when].items():
            check(rl["compiles"] == 0 and rl["store_hits"] == 1,
                  f"{when}: {name} came back from the store uncompiled")
    return out


#: The fresh process of the warm-start phase: a LogicEngine on the card over
#: the precompiled store serves each graph once; it prints its counters.
WARM_START_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp import kernel as K
from repro_torch.serve import LogicEngine

store_dir, graphs_npz, names = sys.argv[1], sys.argv[2], sys.argv[3]
n_unit, capacity, seed, size = map(int, sys.argv[4:8])
data = np.load(graphs_npz)
engine = LogicEngine(CompileSpec(n_unit=n_unit), capacity=capacity,
                     store=ArtifactStore(store_dir))
rng = np.random.default_rng(seed)
out = {"first_request_s": {}, "exact": {}}
for name in names.split(","):
    g = LogicGraph(n_inputs=int(data[name + "_n_inputs"]),
                   gates=list(map(tuple, data[name + "_gates"].tolist())),
                   outputs=data[name + "_outputs"].tolist(), name=name)
    x = rng.integers(0, 2, (size, g.n_inputs)).astype(bool)
    t0 = time.perf_counter()
    y = engine.serve(g, x)
    torch.cuda.synchronize()
    out["first_request_s"][name] = time.perf_counter() - t0
    out["exact"][name] = bool((y == g.evaluate(x)).all())
st = engine.cache.stats()
out.update(device=str(engine.device), compiles=st["compiles"],
           store_hits=st["store_hits"], waves=engine.invocations,
           launches={k: K.launch_count(k) for k in ("logic", "mega", "xnor")})
print(json.dumps(out))
"""


def warm_start_phase(args, smi, tenants, cold_first_request_s) -> dict:
    """Fleet warm start on the card: the port's precompile tool publishes
    fc1 and fc2 into a fresh store, a fresh process serves each once from
    it, and ``python -m repro_torch.tools.verify_program --store S --json``
    audits the store.  Gated: zero compiles there, two store hits,
    bit-exact results, the audit's exit 0 with both entries clean; the
    first request's time warm (store load) is reported beside the front
    door's cold one (optimize + compile).  The launches are the child's,
    read from its own counters."""
    import numpy as np

    from repro_torch.core.artifact_store import ArtifactStore
    from repro_torch.core.spec import CompileSpec
    from repro_torch.tools.precompile import precompile_graph

    spec = CompileSpec(n_unit=256)
    pre = {}
    with tempfile.TemporaryDirectory(prefix="warm_start_",
                                     dir=scratch_dir()) as d:
        store = ArtifactStore(Path(d) / "store")
        for name, g in tenants.items():
            t0 = time.perf_counter()
            key, art, compile_s = precompile_graph(store, g, spec, None)
            pre[name] = {"seconds": time.perf_counter() - t0,
                         "compile_s": compile_s, "key": key,
                         "programs": len(art.programs)}
        npz = Path(d) / "graphs.npz"
        np.savez(npz, **{f"{n}_{k}": v for n, g in tenants.items()
                         for k, v in (("n_inputs", np.int64(g.n_inputs)),
                                      ("gates", np.asarray(g.gates,
                                                           np.int64)),
                                      ("outputs", np.asarray(g.outputs,
                                                             np.int64)))})
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(SRC), env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", WARM_START_CHILD, str(store.root),
             str(npz), ",".join(tenants), str(spec.n_unit), str(CAPACITY),
             str(args.seed + 9), str(FD_SIZE_MEAN)],
            env=env, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        # the store audit an operator runs before promoting the store
        t0 = time.perf_counter()
        audit = subprocess.run(
            [sys.executable, "-m", "repro_torch.tools.verify_program",
             "--store", str(store.root), "--json"],
            env=env, capture_output=True, text=True, timeout=600)
        audit_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the warm-start process ran: {proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    entries = [json.loads(ln) for ln in audit.stdout.strip().splitlines()
               if ln.startswith("{")]
    out = {"phase": "warm_start", "nvidia_smi": smi, "precompile": pre,
           "child_s": child_s,
           "child": child,
           "first_request_ms": {
               n: {"cold": cold_first_request_s[n] * 1e3,
                   "warm": child["first_request_s"][n] * 1e3}
               for n in tenants},
           "launches": child["launches"],
           "verify_program": {
               "rc": audit.returncode, "seconds": audit_s,
               "entries": [{k: e.get(k) for k in ("key", "name", "ok",
                                                  "n_programs", "elapsed_s",
                                                  "diagnostics")}
                           for e in entries],
               "stderr": audit.stderr.strip()[-600:]}}
    emit(out)
    check(audit.returncode == 0 and len(entries) == len(tenants) and
          all(e["ok"] and not e["diagnostics"] for e in entries) and
          sorted(e["key"] for e in entries) ==
          sorted(p["key"] for p in pre.values()),
          f"verify_program finds both entries clean: {out['verify_program']}")
    check(child["device"].startswith("cuda"), "the child served on the card")
    check(child["compiles"] == 0 and child["store_hits"] == len(tenants),
          f"zero compiles and {len(tenants)} store hits: {child}")
    check(all(child["exact"].values()), "warm-start results are bit-exact")
    check(child["launches"]["mega"] == child["waves"] == len(tenants) and
          child["launches"]["logic"] == 0,
          f"one K2 launch per warm wave: {child}")
    return out


def word_err(a, b) -> int:
    """The largest difference between two word (or int) tensors."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def quickstart_phase(torch, dev, smi) -> dict:
    """The paper's quickstart on the card (``repro_torch.examples
    .quickstart``): a Verilog module (5-input majority and parity) parsed,
    synthesized by the pass pipeline, scheduled on 4 units and run through
    ``logic_infer_bits``, one K1 launch.  Gated: K1's output equals the
    plain version (words and bits), direct evaluation and the majority /
    parity ground truth on 1,000 vectors.  Reported: gates, steps and the
    cost model's cycles."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.kernels.logic_dsp import ops

    t0 = time.perf_counter()
    K.reset_launch_counts()                     # quickstart path starts here
    r = quickstart.run(device=dev)
    torch.cuda.synchronize()
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    wall_s = time.perf_counter() - t0           # quickstart path ends here
    prog, x, graph, b = r["program"], r["x"], r["graph"], r["cost"]
    words = ops.pack_bits(torch.from_numpy(x).to(dev))
    err = word_err(ops.logic_forward(prog, words),
                   ops.logic_forward(prog, words, use_ref=True))
    torch.cuda.synchronize()
    plain = ops.logic_infer_bits(prog, x, device=dev, use_ref=True)
    exact = {"kernel_vs_plain": bool((r["out"] == plain).all()),
             "kernel_vs_evaluate": bool((r["out"] == graph.evaluate(x))
                                        .all()),
             "majority": bool((r["out"][:, 0] == (x.sum(1) >= 3)).all()),
             "parity": bool((r["out"][:, 1] == (x.sum(1) % 2 == 1)).all())}
    out = {"phase": "quickstart", "nvidia_smi": smi,
           "module": r["parsed"].name, "parsed": r["parsed"].stats(),
           "synthesized": graph.stats(), "gates": graph.n_gates,
           "steps": prog.n_steps, "n_addr": prog.n_addr,
           "n_unit": prog.n_unit, "vectors": len(x),
           "cost_model": {"cycles": b.n_total_pipelined,
                          "data_moves": b.n_data_moves,
                          "compute": b.n_compute, "bound": b.bound},
           "exact": exact, "max_abs_err": err, "tolerance": 0,
           "wall_s": wall_s, "launches": launches}
    emit(out)
    check(all(exact.values()) and err == 0,
          f"quickstart: K1 == plain == evaluate == ground truth: {exact}")
    check(launches["logic"] == 1 and launches["mega"] == 0,
          f"quickstart: one K1 launch: {launches}")
    return out


def logic_ffn_phase(args, torch, dev, smi, cuda_ms) -> dict:
    """The logic-FFN swap on the card (paper §7.1 inside a transformer),
    at the widths of the reference's example: a 2-layer qwen3-smoke
    transformer (d_model 48, d_ff 24) whose FFNs are binarized (w_in =
    0.5 N(0,1), b_in = 0, w_out = 0.1 N(0,1) from ``--seed``, untrained).
    Calibration bits are each layer's FFN inputs from the binary model
    over ``LOGIC_FFN_CALIB`` TokenPipeline batches; ``ffn_to_program``
    converts each layer, and the logic model (K1 for every FFN) runs the
    calibration batches and a held-out one.  Gated: K1's hidden bits equal
    the plain executor's and ``binary_ffn``'s in both layers, and the
    logits equal the binary model's within 1e-6 on the calibration
    batches.  Reported: conversion seconds, gates and steps per layer,
    K1's device ms per call, and the held-out argmax agreement (not
    gated: unseen patterns may differ, paper §7.1)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.spec import CompileSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.examples import logic_mlp_swap as swap
    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.kernels.logic_dsp import ops
    from repro_torch.models import logic_mlp

    cfg = get_config(LM_ARCH, smoke=True).with_(**LOGIC_FFN)
    model = swap.init_swap_model(cfg, args.seed, dev)
    pipe = TokenPipeline(cfg.vocab_size, 8, 32, seed=args.seed)
    calib = [torch.from_numpy(pipe.batch(900 + i)["tokens"]).to(dev)
             for i in range(LOGIC_FFN_CALIB)]
    held = torch.from_numpy(pipe.batch(LOGIC_FFN_HELD_OUT)["tokens"]).to(dev)
    d = cfg.d_model
    binary, captured = [], [[] for _ in model.blocks]
    with torch.inference_mode():
        for tokens in calib:
            ins = []
            binary.append(model(tokens, ffn_inputs=ins))
            for i, h in enumerate(ins):
                captured[i].append(h.reshape(-1, d))
        binary_held = model(held)

    layers, t0 = [], time.perf_counter()
    for i, blk in enumerate(model.blocks):
        bits = (torch.cat(captured[i]) >= 0).cpu().numpy()
        t1 = time.perf_counter()
        blk.program = logic_mlp.ffn_to_program(
            blk.params(), bits, CompileSpec(n_unit=LOGIC_FFN_UNIT),
            name=f"ffn{i}")
        layers.append({"samples": len(bits),
                       "distinct_patterns": len(np.unique(bits, axis=0)),
                       "gates": blk.program.n_gates,
                       "steps": blk.program.n_steps,
                       "n_addr": blk.program.n_addr,
                       "convert_s": time.perf_counter() - t1})
    convert_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    K.reset_launch_counts()                     # logic-FFN path starts here
    logic, logic_inputs = [], []
    with torch.inference_mode():
        for tokens in calib:
            ins = []
            logic.append(model(tokens, ffn_inputs=ins))
            logic_inputs.append(ins)
        held_inputs = []
        logic_held = model(held, ffn_inputs=held_inputs)
    torch.cuda.synchronize()
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    wall_s = time.perf_counter() - t0           # logic-FFN path ends here

    err, hidden_equal = 0, True
    with torch.inference_mode():
        for ins in logic_inputs:
            for blk, h in zip(model.blocks, ins):
                words = ops.pack_bits((h.float() >= 0).reshape(-1, d))
                k1 = ops.logic_forward(blk.program, words)
                err = max(err, word_err(k1, ops.logic_forward(
                    blk.program, words, use_ref=True)))
                hidden = ops.unpack_bits(k1, h.shape[0] * h.shape[1])
                hidden_equal &= torch.equal(
                    hidden, logic_mlp.binary_hidden(blk.params(), h))
    logit_err = max(float((a - b).abs().max()) for a, b in zip(logic,
                                                              binary))
    vocab = cfg.vocab_size
    agree = float((logic_held[..., :vocab].argmax(-1) ==
                   binary_held[..., :vocab].argmax(-1)).float().mean())

    prog = model.blocks[0].program
    words = ops.pack_bits((held_inputs[0].float() >= 0).reshape(-1, d))
    a = ops.program_arrays(prog, dev)
    k1_call = (lambda: K.logic_cuda_call(a["rec"], words, a["output_addrs"],
                                         n_addr=prog.n_addr, plan=a["plan"]))
    out = {"phase": "logic_ffn", "nvidia_smi": smi,
           "model": f"{cfg.name} at the logic_mlp_swap widths",
           "config": {k: getattr(cfg, k) for k in LOGIC_FFN},
           "calibration_batches": LOGIC_FFN_CALIB, "n_unit": LOGIC_FFN_UNIT,
           "layers": layers, "convert_s": convert_s,
           "hidden_bits_equal": hidden_equal, "max_abs_err": err,
           "tolerance": 0, "logits_max_abs_diff": logit_err,
           "logits_tolerance": 1e-6, "held_out_argmax_agreement": agree,
           "k1_words": words.shape[1],
           "k1_device_ms": device_ms_per_call(torch, k1_call, 50),
           "k1_plain_ms": cuda_ms(lambda: ops.logic_forward(
               prog, words, use_ref=True), 3, warmup=1),
           "k1_scratch": a["plan"].scratch, "wall_s": wall_s,
           "launches": launches}
    emit(out)
    check(err == 0 and hidden_equal,
          "logic FFN: K1's hidden bits == plain == binary_ffn's")
    check(logit_err <= 1e-6,
          f"logic FFN: logits == the binary model's ({logit_err})")
    check(launches["logic"] == cfg.n_layers * (LOGIC_FFN_CALIB + 1) and
          launches["mega"] == 0,
          f"logic FFN: one K1 launch per layer and batch: {launches}")
    return out


def lm_phase(args, torch, dev, smi) -> dict:
    """LM serving on the card: qwen3-8b at full width and depth (36
    layers, d 4096, 32 heads over 8 KV heads, d_ff 12,288, vocab 151,936),
    random weights from ``--seed``.  (a) Parity in float32 with TF32 off:
    prefill of the first tokens plus one decode step per remaining token
    against the full forward, at the reference test's tolerance (gated);
    the float32 copy is freed after.  (b) Serving in the config's bf16
    through ``launch.serve``'s loop at its defaults (gated: every request
    finishes with ``max_new`` tokens, each id in the vocabulary), with
    prefill and decode-step times, tokens per second, the peak of device
    memory, the device's idle share over a traced decode loop and the
    decode step's byte floor (every weight it reads, once, at the HBM
    rate) reported."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import decode_step, prefill

    cfg = get_config(LM_ARCH)
    out = {"phase": "lm", "nvidia_smi": smi, "model": cfg.name,
           "config": {k: getattr(cfg, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab_size", "qk_norm", "param_dtype",
               "compute_dtype")},
           "params": cfg.param_count()}

    # (a) parity in float32
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = init_params(cfg.with_(param_dtype="float32",
                                  compute_dtype="float32"),
                        torch.Generator(dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 21)
    B, S = LM_PARITY_BATCH, LM_PARITY_TOKENS
    P = S - LM_PARITY_DECODE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        full = model(toks)
        lp, cache = prefill(model, toks[:, :P], context=S)
        pairs = [(lp, full[:, :P])]
        for t in range(P, S):
            lg, cache = decode_step(model, toks[:, t:t + 1], cache)
            pairs.append((lg[:, 0], full[:, t]))
    torch.cuda.synchronize()
    parity_s = time.perf_counter() - t0
    tol = LM_PARITY_TOL
    held = [bool(torch.allclose(a, b, rtol=tol, atol=tol)) for a, b in pairs]
    out["parity"] = {
        "dtype": "float32", "allow_tf32": False, "batch": B, "tokens": S,
        "prefill": P, "decode_steps": S - P, "rtol": tol, "atol": tol,
        "max_abs_diff": max(float((a - b).abs().max()) for a, b in pairs),
        "logits_max_abs": float(full.abs().max()), "held": held,
        "finite": bool(torch.isfinite(full).all()),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in model.parameters()),
        "init_s": init_s, "seconds": parity_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    del model, full, lp, lg, cache, pairs
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    # (b) serving in bf16
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                        dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sv = LM_SERVE
    prompts = launch_serve.make_prompts(cfg, sv["requests"],
                                        sv["prompt_len"], args.seed)
    launch_serve.serve(model, prompts[:1], batch_size=1, max_new=2,
                       context=sv["context"])                   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    r = launch_serve.serve(model, prompts, batch_size=sv["batch_size"],
                           max_new=sv["max_new"], context=sv["context"])
    peak = torch.cuda.max_memory_allocated(dev)

    state = {}

    def decode_loop():
        _, state["cache"] = prefill(
            model, torch.as_tensor(prompts[0], device=dev)[None],
            context=sv["context"])
        tok = int(prompts[0][-1])
        for _ in range(LM_TRACED_STEPS):
            logits, state["cache"] = decode_step(
                model, torch.tensor([[tok]], device=dev), state["cache"])
            tok = int(torch.argmax(logits[0, -1]))

    wall_us, busy_us, by_name, _ = traced(torch, decode_loop)
    host = decode_step_host_profile(torch, model, state["cache"], dev)
    # what one decode step must read: every block weight, the final norm
    # and the LM head once, one embedding row
    step_bytes = sum(p.numel() * p.element_size() for blk in model.blocks
                     for p in blk.parameters()) + sum(
        p.numel() * p.element_size() for p in (model.final_norm,
                                                model.lm_head)) + \
        cfg.d_model * model.embed.element_size()
    dec = np.asarray(r["decode_s"]) * 1e3
    pre = np.asarray(r["prefill_s"]) * 1e3
    finished = r["finished"]
    out["serve"] = {
        **sv, "init_s": init_s,
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in model.parameters()),
        "finished": len(finished), "decode_steps": r["n_steps"],
        "seconds": r["seconds"], "tok_per_s": r["n_steps"] / r["seconds"],
        "prefill_ms_p50": float(np.median(pre)),
        "prefill_ms_max": float(pre.max()),
        "decode_step_ms_p50": float(np.percentile(dec, 50)),
        "decode_step_ms_p90": float(np.percentile(dec, 90)),
        "max_memory_allocated": peak,
        "decode_step_bytes": step_bytes,
        "decode_step_floor_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "traced_decode_steps": LM_TRACED_STEPS,
        "traced_wall_ms": wall_us / 1e3,
        "device_busy_ms": None if busy_us is None else busy_us / 1e3,
        "device_idle_share": (None if busy_us is None
                              else 1 - busy_us / wall_us),
        "device_ms_by_name": dict(by_name[:5]),
        "one_step_host_profile": host,
        "first_tokens": {q.uid: q.generated for q in finished[:2]}}
    out["serve"]["decode_step_vs_floor"] = \
        out["serve"]["decode_step_ms_p50"] / \
        out["serve"]["decode_step_floor_ms"]
    emit(out)
    p = out["parity"]
    check(p["finite"] and all(p["held"]),
          f"lm: prefill + decode == forward within {tol} in float32 "
          f"({p['max_abs_diff']})")
    check(sorted(q.uid for q in finished) == list(range(sv["requests"])),
          "lm: every request finished")
    check(all(len(q.generated) == sv["max_new"] and
              all(0 <= t < cfg.vocab_size for t in q.generated)
              for q in finished),
          f"lm: {sv['max_new']} tokens per request, each in the vocabulary")
    del model, state
    torch.cuda.empty_cache()
    return out


def families_phase(args, torch, dev, smi) -> None:
    """The MoE, SSM, hybrid, VLM and audio families at full width, one
    line each (:func:`family_case`).  They launch no ported kernel: their
    scans and dispatch are plain PyTorch, as they are XLA in the
    reference; the K1/K2/K3 counts over the phase are reported."""
    from repro_torch.kernels.logic_dsp import kernel as K

    K.reset_launch_counts()                     # families path starts here
    for arch, plan in FAMILIES.items():
        family_case(args, torch, dev, smi, arch, plan)
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    emit({"phase": "families", "models": list(FAMILIES),
          "launches": launches, "nvidia_smi": smi})


def family_inputs(torch, cfg, batch, tokens, rng, dev):
    """Seeded inputs of the family on ``dev``: ``(tokens, kw)`` where kw
    holds ``frames`` (audio: tokens is None) or ``vision`` (vlm)."""
    if cfg.family == "audio":
        frames = rng.normal(size=(batch, tokens, cfg.frontend_dim))
        return None, {"frames": torch.from_numpy(frames).float().to(dev)}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (batch, tokens))).to(dev)
    if cfg.family != "vlm":
        return toks, {}
    vis = rng.normal(size=(batch, cfg.vision_tokens, cfg.d_model))
    return toks, {"vision": torch.from_numpy(vis).float().to(dev)}


def set_capacity_factor(model, cf: float) -> None:
    """Route ``model``'s MoE layers at capacity factor ``cf``, same
    weights."""
    cfg = model.cfg.with_(capacity_factor=cf)
    model.cfg = cfg
    for blk in model.blocks:
        blk.cfg = cfg


def moe_routing(torch, model, toks) -> list:
    """Each MoE layer's routing over a forward of ``toks``: (top-k
    experts, buffer slots, capacity) per layer."""
    from repro_torch.models import moe
    ins = []
    with torch.inference_mode():
        model(toks, ins)
    out = []
    for blk, h in zip(model.blocks, ins):
        _, idx, _, a_slot, _, cap = moe.route(blk.params(), h, model.cfg)
        out.append((idx, a_slot, cap))
    return out


def prefill_decode_pairs(torch, model, toks, kw, n_decode):
    """The forward over ``toks`` and prefill of all but the last
    ``n_decode`` tokens plus one decode step for each: (logits, forward)
    pairs and the forward's logits."""
    from repro_torch.serve import decode_step, prefill
    off = model.cfg.vision_tokens if "vision" in kw else 0
    s = toks.shape[1]
    p = s - n_decode
    with torch.inference_mode():
        full = model(toks, **kw)
        lp, cache = prefill(model, toks[:, :p], context=s + off, **kw)
        pairs = [(lp, full[:, :off + p])]
        for t in range(p, s):
            lg, cache = decode_step(model, toks[:, t:t + 1], cache)
            pairs.append((lg[:, 0], full[:, off + t]))
    return pairs, full


def pairs_summary(torch, pairs, tol) -> dict:
    return {"rtol": tol, "atol": tol,
            "max_abs_diff": max(float((a - b).abs().max())
                                for a, b in pairs),
            "held": [bool(torch.allclose(a, b, rtol=tol, atol=tol))
                     for a, b in pairs],
            "finite": all(bool(torch.isfinite(a).all()) for a, _ in pairs)}


def family_case(args, torch, dev, smi, arch, plan) -> dict:
    """One family at full width, random weights from ``--seed``: (a)
    float32 (TF32 off) prefill + decode against the forward on the card
    (gated; mixtral also at 1.25, its drops reported), (b) the float32
    forward on the card against the CPU's (gated), (c) serving in the
    config's dtype: the launcher's loop (vlm: prefill with stub patch
    embeddings, then decode; audio: the encoder forward over stub frames),
    every request finished with in-vocabulary ids (gated), with prefill
    and decode-step times, tokens per second, peak memory, the device's
    idle share over a traced decode loop and the step's byte floor."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer, init_params

    cfg = get_config(arch)
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    out = {"phase": "families", "model": cfg.name, "family": cfg.family,
           "nvidia_smi": smi,
           "config": {k: getattr(cfg, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab_size", "n_experts", "experts_per_token",
               "capacity_factor", "sliding_window", "ssm_state",
               "ssm_chunk", "block_pattern", "local_window",
               "vision_tokens", "frontend_dim", "param_dtype")},
           "params": cfg.param_count(), "reduced": {}}

    def layers(run):
        n = min(plan[run], cfg.n_layers)
        if n < cfg.n_layers:
            out["reduced"][run] = {
                "n_layers": n, "of": cfg.n_layers,
                "bytes": cfg.with_(n_layers=n).param_count() *
                (4 if run != "serve" else 2),
                "whole_bytes": cfg.param_count() *
                (4 if run != "serve" else 2)}
        return n

    rng = np.random.default_rng(args.seed + 31)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (a) float32 self-consistency on the card
        if plan["self_check"] is not None:
            kw_cfg = dict(f32)
            if cfg.family == "moe":
                kw_cfg["capacity_factor"] = \
                    cfg.n_experts / cfg.experts_per_token
            c32 = cfg.with_(n_layers=layers("self_check"), **kw_cfg)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            model = init_params(c32, torch.Generator(dev).manual_seed(
                args.seed), dev)
            toks, kw = family_inputs(torch, c32, plan["batch"],
                                     plan["tokens"], rng, dev)
            pairs, full = prefill_decode_pairs(torch, model, toks, kw,
                                               plan["decode"])
            torch.cuda.synchronize()
            sc = {"dtype": "float32", "allow_tf32": False,
                  "n_layers": c32.n_layers, "batch": plan["batch"],
                  "tokens": plan["tokens"], "decode_steps": plan["decode"],
                  "prefill": plan["tokens"] - plan["decode"],
                  **pairs_summary(torch, pairs, FAMILY_PARITY_TOL),
                  "logits_max_abs": float(
                      full[..., :cfg.vocab_size].abs().max()),
                  "max_memory_allocated":
                      torch.cuda.max_memory_allocated(dev)}
            if cfg.family == "moe":
                # cap >= S at n_experts / k: nothing can drop
                from repro_torch.models.moe import capacity
                sc["capacity_factor"] = c32.capacity_factor
                sc["no_drop_possible"] = all(
                    capacity(c32, n) >= n for n in range(1, toks.shape[1] + 1))
                p = plan["tokens"] - plan["decode"]
                set_capacity_factor(model, cfg.capacity_factor)
                routes = {"forward": moe_routing(torch, model, toks),
                          "prefill": moe_routing(torch, model,
                                                 toks[:, :p])}
                pairs125, _ = prefill_decode_pairs(torch, model, toks, kw,
                                                   plan["decode"])
                e = cfg.n_experts
                sc["at_config_capacity_factor"] = {
                    "capacity_factor": cfg.capacity_factor,
                    "capacity": {k: r[0][2] for k, r in routes.items()},
                    "dropped_by_layer": {
                        k: [int((slot == e * cap).sum())
                            for _, slot, cap in r]
                        for k, r in routes.items()},
                    "assignments_per_layer": {
                        k: int(r[0][0].numel()) for k, r in routes.items()},
                    **{k: v for k, v in pairs_summary(
                        torch, pairs125, FAMILY_PARITY_TOL).items()
                       if k in ("max_abs_diff", "held", "finite")}}
            sc["seconds"] = time.perf_counter() - t0
            out["self_consistency"] = sc
            del model, pairs, full, toks, kw
            torch.cuda.empty_cache()

        # (b) float32 card against CPU
        t0 = time.perf_counter()
        cc = cfg.with_(n_layers=layers("vs_cpu"), **f32)
        card = init_params(cc, torch.Generator(dev).manual_seed(
            args.seed + 1), dev)
        cpu = Transformer(cc, device="cpu")
        cpu.load_state_dict(card.state_dict())
        n_tok = FAMILY_FRAMES[1] if cfg.family == "audio" else \
            FAMILY_VS_CPU_TOKENS
        toks, kw = family_inputs(torch, cc, 1, n_tok, rng, dev)
        with torch.inference_mode():
            got = card(toks, **kw).cpu()
            want = cpu(None if toks is None else toks.cpu(),
                       **{k: v.cpu() for k, v in kw.items()})
        tol = FAMILY_VS_CPU_TOL
        vs = {"dtype": "float32", "allow_tf32": False,
              "n_layers": cc.n_layers, "batch": 1, "tokens": n_tok,
              "rtol": tol, "atol": tol,
              "max_abs_diff": float((got - want).abs().max()),
              "logits_max_abs": float(
                  want[..., :cfg.vocab_size].abs().max()),
              "held": bool(torch.allclose(got, want, rtol=tol, atol=tol)),
              "finite": bool(torch.isfinite(got).all() and
                             torch.isfinite(want).all())}
        if cfg.family == "moe":
            a = moe_routing(torch, card, toks)
            b = moe_routing(torch, cpu, toks.cpu())
            vs["routing_differences"] = sum(
                int((x[0].cpu() != y[0]).sum()) for x, y in zip(a, b))
            vs["slot_differences"] = sum(
                int((x[1].cpu() != y[1]).sum()) for x, y in zip(a, b))
        vs["seconds"] = time.perf_counter() - t0
        out["vs_cpu"] = vs
        del card, cpu, got, want, toks, kw
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    # (c) serving in the config's dtype
    out["serve"] = family_serve(args, torch, dev, cfg.with_(
        n_layers=layers("serve")), rng)
    emit(out)
    name = cfg.name
    if "self_consistency" in out:
        sc = out["self_consistency"]
        check(sc["finite"] and all(sc["held"]),
              f"{name}: prefill + decode == forward within "
              f"{FAMILY_PARITY_TOL} in float32 ({sc['max_abs_diff']})")
    check(out["vs_cpu"]["finite"] and out["vs_cpu"]["held"],
          f"{name}: card == CPU within {FAMILY_VS_CPU_TOL} in float32 "
          f"({out['vs_cpu']['max_abs_diff']})")
    sv = out["serve"]
    check(out.get("self_consistency", {}).get("no_drop_possible", True),
          f"{name}: the float32 gate's capacity drops nothing")
    check(sv["finite"], f"{name}: served logits are finite")
    check(sv["finished"] == sv["requests"] and sv["in_vocabulary"],
          f"{name}: every request finished with in-vocabulary ids")
    return out


def family_serve(args, torch, dev, cfg, rng) -> dict:
    """Serving in the config's dtype at ``cfg``'s depth (see
    :func:`family_case`)."""
    import numpy as np

    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import decode_step, prefill

    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                        dev)
    torch.cuda.synchronize()
    out = {"n_layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "init_s": time.perf_counter() - t0,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters())}
    if cfg.family == "audio":
        out.update(encoder_serve(torch, model, rng, dev))
        del model
        torch.cuda.empty_cache()
        return out
    sv = FAMILY_SERVE
    n_vis = cfg.vision_tokens if cfg.family == "vlm" else 0
    context = sv["context"] + n_vis
    prompts = launch_serve.make_prompts(cfg, sv["requests"],
                                        sv["prompt_len"], args.seed)
    vision = None
    if n_vis:
        vision = [torch.from_numpy(rng.normal(
            size=(1, n_vis, cfg.d_model))).to(dev, torch.bfloat16)
            for _ in prompts]

    def serve_all(ps, max_new):
        if vision is None:
            return launch_serve.serve(model, ps, batch_size=sv["batch_size"],
                                      max_new=max_new, context=context)
        return serve_with_vision(torch, model, ps, vision, max_new, context)

    serve_all(prompts[:1], 2)                                  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    r = serve_all(prompts, sv["max_new"])
    peak = torch.cuda.max_memory_allocated(dev)
    state = {"finite": True}
    vis0 = {} if vision is None else {"vision": vision[0]}

    def decode_loop():
        logits, state["cache"] = prefill(
            model, torch.as_tensor(prompts[0], device=dev)[None],
            context=context, **vis0)
        ok = [torch.isfinite(logits[..., :cfg.vocab_size]).all()]
        tok = int(prompts[0][-1])
        for _ in range(FAMILY_TRACED_STEPS):
            logits, state["cache"] = decode_step(
                model, torch.tensor([[tok]], device=dev), state["cache"])
            ok.append(torch.isfinite(logits[..., :cfg.vocab_size]).all())
            tok = int(torch.argmax(logits[0, -1]))
        state["finite"] = bool(torch.stack(ok).all())

    wall_us, busy_us, by_name, launches = traced(torch, decode_loop)
    host = decode_step_host_profile(torch, model, state["cache"], dev)
    step_bytes = decode_step_bytes(model, state["cache"])
    dec = np.asarray(r["decode_s"]) * 1e3
    pre = np.asarray(r["prefill_s"]) * 1e3
    finished = r["finished"]
    out.update({
        **sv, "context": context, "vision_tokens": n_vis,
        "requests": sv["requests"], "finished": len(finished),
        "in_vocabulary": sorted(q.uid for q in finished) ==
        list(range(sv["requests"])) and all(
            len(q.generated) == sv["max_new"] and
            all(0 <= t < cfg.vocab_size for t in q.generated)
            for q in finished),
        "finite": state["finite"], "decode_steps": r["n_steps"],
        "seconds": r["seconds"], "tok_per_s": r["n_steps"] / r["seconds"],
        "prefill_ms_p50": float(np.median(pre)),
        "prefill_ms_max": float(pre.max()),
        "decode_step_ms_p50": float(np.percentile(dec, 50)),
        "decode_step_ms_p90": float(np.percentile(dec, 90)),
        "max_memory_allocated": peak,
        "decode_step_bytes": step_bytes,
        "decode_step_floor_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "traced_decode_steps": FAMILY_TRACED_STEPS,
        "traced_wall_ms": wall_us / 1e3,
        "traced_kernel_launches": launches,
        "device_busy_ms": None if busy_us is None else busy_us / 1e3,
        "device_idle_share": (None if busy_us is None
                              else 1 - busy_us / wall_us),
        "device_ms_by_name": dict(by_name[:5]),
        "one_step_host_profile": host,
        "first_tokens": {q.uid: q.generated for q in finished[:2]}})
    out["decode_step_vs_floor"] = \
        out["decode_step_ms_p50"] / out["decode_step_floor_ms"]
    del model, state
    torch.cuda.empty_cache()
    return out


def serve_with_vision(torch, model, prompts, vision, max_new: int,
                      context: int) -> dict:
    """The launcher's loop for a vlm, one request at a time: prefill of
    the request's stub patch embeddings and prompt, then ``max_new``
    greedy decode steps, the first fed the prompt's last token again (as
    ``launch.serve`` does).  The same result keys as ``launch.serve``'s
    ``serve``."""
    from types import SimpleNamespace

    from repro_torch.serve import decode_step, prefill

    dev = model.device
    prefill_s, decode_s, finished = [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for uid, (prompt, vis) in enumerate(zip(prompts, vision)):
            t1 = time.perf_counter()
            _, cache = prefill(model, torch.as_tensor(prompt,
                                                      device=dev)[None],
                               context=context, vision=vis)
            torch.cuda.synchronize(dev)
            prefill_s.append(time.perf_counter() - t1)
            tok, generated = int(prompt[-1]), []
            for _ in range(max_new):
                t1 = time.perf_counter()
                logits, cache = decode_step(
                    model, torch.tensor([[tok]], device=dev), cache)
                tok = int(torch.argmax(logits[0, -1]))
                decode_s.append(time.perf_counter() - t1)
                generated.append(tok)
            finished.append(SimpleNamespace(uid=uid, generated=generated))
    return {"finished": finished, "n_steps": len(decode_s),
            "seconds": time.perf_counter() - t0, "prefill_s": prefill_s,
            "decode_s": decode_s}


def encoder_serve(torch, model, rng, dev) -> dict:
    """The audio encoder's serving: its forward over FAMILY_FRAMES stub
    frames, timed over 5 calls after a warm-up, one traced, with its
    floors (every weight and the frames read once, the logits written
    once, at the HBM rate; 2 x parameters x frames at the bf16 peak)."""
    import numpy as np

    cfg = model.cfg
    b, s = FAMILY_FRAMES
    frames = torch.from_numpy(rng.normal(size=(b, s, cfg.frontend_dim))
                              ).to(dev, torch.bfloat16)
    with torch.inference_mode():
        model(frames=frames)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            logits = model(frames=frames)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        ids = torch.argmax(logits, dim=-1)
        wall_us, busy_us, by_name, launches = traced(
            torch, lambda: model(frames=frames))
    ms = np.asarray(times) * 1e3
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    nbytes = param_bytes + frames.numel() * frames.element_size() + \
        logits.numel() * logits.element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * cfg.param_count() * b * s / BF16_FLOPS_PER_S * 1e3
    return {"batch": b, "frames": s, "requests": b, "finished": b,
            "in_vocabulary": bool((ids < cfg.vocab_size).all()),
            "finite": bool(torch.isfinite(
                logits[..., :cfg.vocab_size]).all()),
            "forward_ms_p50": float(np.median(ms)),
            "forward_ms_max": float(ms.max()),
            "frames_per_s": b * s / float(np.median(ms)) * 1e3,
            "max_memory_allocated": peak,
            "forward_floor_ms": max(bytes_ms, ops_ms),
            "forward_bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations",
            "traced_wall_ms": wall_us / 1e3,
            "traced_kernel_launches": launches,
            "device_busy_ms": None if busy_us is None else busy_us / 1e3,
            "device_idle_share": (None if busy_us is None
                                  else 1 - busy_us / wall_us),
            "device_ms_by_name": dict(by_name[:5])}


def decode_step_bytes(model, cache) -> int:
    """What one decode step at batch 1 must read once: every block weight
    but the experts the token does not route to (a token routes to k
    distinct experts a layer), the final norm, the head, one embedding
    row, and the cache's live state (the written KV entries, the SSM
    state and conv carries, the RG-LRU state and carries)."""
    cfg = model.cfg
    total = 0
    for blk in model.blocks:
        for name, p in blk.named_parameters(recurse=False):
            nb = p.numel() * p.element_size()
            if blk.kind == "moe" and name in ("w_gate", "w_up", "w_down"):
                nb = nb * cfg.experts_per_token // cfg.n_experts
            total += nb
    head = model.embed if cfg.tie_embeddings else model.lm_head
    total += sum(p.numel() * p.element_size()
                 for p in (model.final_norm, head))
    total += cfg.d_model * model.embed.element_size()
    for name in ("kv_k", "kv_v", "ssm_state", "conv_carry", "rec_h",
                 "rec_conv"):
        t = getattr(cache, name)
        if t is None:
            continue
        nb = t.numel() * t.element_size()
        if name.startswith("kv"):
            nb = nb * min(cache.length + 1, t.shape[2]) // t.shape[2]
        total += nb
    return total


def saved_signal_handlers():
    """The SIGTERM and SIGINT handlers now (a Trainer's PreemptionGuard
    replaces both); :func:`restore_signal_handlers` puts them back."""
    import signal
    return {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}


def restore_signal_handlers(saved: dict) -> None:
    import signal
    for s, h in saved.items():
        signal.signal(s, h)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def timed_saves(trainer) -> list:
    """Wrap ``trainer.ckpt.save`` to record (seconds, step) of each
    save; returns the list it fills."""
    saves, save = [], trainer.ckpt.save

    def timed(step, *a, **kw):
        t0 = time.perf_counter()
        save(step, *a, **kw)
        saves.append((time.perf_counter() - t0, step))

    trainer.ckpt.save = timed
    return saves


def need_disk(path, nbytes: int, what: str) -> dict:
    """Fail loudly before writing ``nbytes`` of checkpoints where they do
    not fit (with a 10% margin)."""
    import shutil
    free = shutil.disk_usage(path).free
    check(free > 1.1 * nbytes,
          f"{what}: {nbytes / 1e9:.1f} GB of checkpoints need room; "
          f"{free / 1e9:.1f} GB free under {path}")
    return {"free_bytes": free, "need_bytes": nbytes}


def profile_step(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall time, the
    device's busy time and idle share, the kernel launches the host made
    and the device time of the largest kernels."""
    wall_us, busy_us, by_name, launches = traced(torch, fn)
    return {"wall_ms": wall_us / 1e3, "kernel_launches": launches,
            "device_busy_ms": None if busy_us is None else busy_us / 1e3,
            "device_idle_share": (None if busy_us is None
                                  else 1 - busy_us / wall_us),
            "device_ms_by_name": dict(by_name[:6])}


def train_full_phase(args, torch, dev, smi) -> dict:
    """LM training at full size: minicpm-2b's own config (40 layers, d
    2304, 36 heads, vocab 122,753 padded to 122,880, tied embeddings,
    bf16 parameters, float32 moments, remat "full", its WSD schedule),
    built by ``launch/train.py`` from its flags and run by its Trainer for
    ``TRAIN_FULL`` steps (global batch 8 x 512 tokens, 2 micro-batches),
    the final checkpoint written to a temporary directory (the free disk
    checked first) and removed after.  Gated: every loss and grad norm
    finite; one more gradient finite and non-zero in every leaf; on one
    fixed batch, at a constant lr from a fresh optimizer state, the loss
    after ``TRAIN_DESCENT_STEPS`` steps below the first.  Reported: the
    parameter count, peak device memory, step time p50/p90, tokens/s, MFU
    (6 N tokens over the step at the bf16 peak) beside the step's floors,
    one step's launches and the device's idle share (profiler), and the
    checkpoint's bytes and seconds."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import train_loss
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    tf = TRAIN_FULL
    n = cfg.param_count()
    tokens = tf["global_batch"] * tf["seq_len"]
    # the checkpoint: bf16 parameters in their 16 bits, float32 moments
    ckpt_need = n * (2 + 4 + 4)
    out = {"phase": "train_full", "nvidia_smi": smi, "model": cfg.name,
           "config": {k: getattr(cfg, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab_size", "tie_embeddings", "param_dtype",
               "compute_dtype", "moment_dtype", "remat")},
           "padded_vocab": cfg.padded_vocab, "params": n, **tf,
           "tokens_per_step": tokens,
           "disk": need_disk(scratch_dir(), ckpt_need, "train_full")}
    ckdir = tempfile.mkdtemp(prefix="train_full.", dir=scratch_dir())
    handlers = saved_signal_handlers()
    try:
        trainer, targs = launch_train.build([
            "--arch", TRAIN_ARCH, "--steps", str(tf["steps"]),
            "--global-batch", str(tf["global_batch"]),
            "--seq-len", str(tf["seq_len"]),
            "--grad-accum", str(tf["grad_accum"]),
            "--checkpoint-dir", ckdir,
            "--checkpoint-every", str(10 * tf["steps"]),
            "--device", str(dev)])
        saves = timed_saves(trainer)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hist = trainer.run(tf["steps"], log_every=0)
        run_s = time.perf_counter() - t0
        peak_run = torch.cuda.max_memory_allocated(dev)
        model, opt = trainer.model, trainer.opt
        step_s = np.asarray([h["seconds"] for h in hist[1:]])
        p50 = float(np.median(step_s))
        flops6 = 6 * n * tokens
        out["train"] = {
            "schedule": trainer.tc.schedule, "lr": [h["lr"] for h in hist],
            "loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "first_step_s": hist[0]["seconds"],
            "step_s_p50": p50, "step_s_p90": float(np.percentile(step_s,
                                                                   90)),
            "tokens_per_s": tokens / p50,
            "mfu": flops6 / p50 / BF16_FLOPS_PER_S,
            "floor_ms_6nt": flops6 / BF16_FLOPS_PER_S * 1e3,
            "floor_ms_8nt_remat": 8 * n * tokens / BF16_FLOPS_PER_S * 1e3,
            # the update reads p (2), the float32 grad, mu, nu (4 each),
            # writes p, mu, nu
            "optimizer_floor_ms": n * 24 / HBM_BYTES_PER_S * 1e3,
            "run_s": run_s, "max_memory_allocated": peak_run,
            # the config's count is the published one (vocab 122,753);
            # the model holds the padded vocab's rows
            "params_allocated": sum(p.numel() for p in model.parameters()),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "moment_bytes": sum(m.numel() * m.element_size() for m in
                                (*opt.mu.values(), *opt.nu.values()))}
        out["checkpoint"] = {"bytes": dir_bytes(ckdir), "saves": [
            {"seconds": t, "step": st} for t, st in saves],
            "expected_bytes": ckpt_need}
        shutil.rmtree(ckdir, ignore_errors=True)

        batch = trainer.batch(trainer.step)
        out["profiled_step"] = profile_step(
            torch, lambda: trainer.train_step(model, opt, batch))
        # one more step under the FLOP counter, for the dry run's
        # prediction of this cell (dryrun_phase)
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        with counter:
            trainer.train_step(model, opt, batch)
        out["counted_step"] = {"flops": counter.get_total_flops()}
        trainer.opt = opt = None            # the descent starts afresh

        mb = {"tokens": batch["tokens"][:tf["global_batch"] //
                                        tf["grad_accum"]]}
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(train_loss(model, mb),
                                    list(params.values()))
        finite = [bool(torch.isfinite(g).all()) for g in grads]
        nonzero = [bool(g.any()) for g in grads]
        out["grads"] = {"leaves": len(grads), "finite": sum(finite),
                        "nonzero": sum(nonzero),
                        "zero_leaves": [k for k, z in zip(params, nonzero)
                                        if not z][:5]}
        del grads

        step = make_train_step(cfg, TrainConfig(
            lr=TRAIN_DESCENT_LR, schedule="const",
            grad_accum=tf["grad_accum"]))
        opt = adamw_init(params, trainer.moment_dtype)
        fixed = trainer.batch(0)
        descent = []
        for _ in range(TRAIN_DESCENT_STEPS):
            model, opt, m = step(model, opt, fixed)
            descent.append(float(m["loss"]))
        out["descent"] = {"lr": TRAIN_DESCENT_LR, "batch": 0,
                          "loss": descent}
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    finally:
        restore_signal_handlers(handlers)
        shutil.rmtree(ckdir, ignore_errors=True)
    emit(out)
    tr = out["train"]
    check(all(math.isfinite(v) for v in tr["loss"] + tr["grad_norm"]),
          "train_full: every loss and grad norm is finite")
    g = out["grads"]
    check(g["finite"] == g["leaves"] == g["nonzero"],
          f"train_full: every leaf's gradient is finite and non-zero: {g}")
    check(descent[-1] < descent[0],
          f"train_full: the fixed-batch loss falls: {descent}")
    check(out["checkpoint"]["saves"] and
          out["checkpoint"]["saves"][-1]["step"] == tf["steps"],
          "train_full: the final checkpoint was written")
    del trainer, model, opt, params
    torch.cuda.empty_cache()
    return out


def dryrun_phase(smi, full: dict) -> dict:
    """The dry run on the card's PyTorch (``repro_torch.launch.dryrun``).
    Each of DRYRUN_CELLS through the launcher in its own subprocess (a
    fake 256-rank group, fake CUDA tensors, both started together), its
    seconds and its numbers beside the committed ones the CPU's fake
    tensors gave (``results/dryrun_torch``).  Meanwhile train_full's own
    cell (minicpm-2b, TRAIN_FULL's batch and micro-batches, one rank)
    predicted in this process (fake CUDA tensors; the CPU's where
    PyTorch is built without CUDA, ``dryrun.fake_device``).  Gated: each
    cell ``ok``, its FLOPs and collective bytes equal to the CPU's; the
    prediction's FLOPs equal to those the FLOP counter saw in
    train_full's step on the card within DRYRUN_FLOPS_RTOL.  Reported:
    the card's peak memory over the predicted peak, and the roofline's
    bound over train_full's step p50 (its share of the bound)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf

    out = {"phase": "dryrun", "nvidia_smi": smi, "constants":
           dryrun.CONSTANTS}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_",
                                     dir=scratch_dir()) as d:
        procs = {}
        for arch, shape in DRYRUN_CELLS:
            procs[arch, shape] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "pod1",
                 "--out", d], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        try:
            cfg = get_config(TRAIN_ARCH)
            tf = TRAIN_FULL
            cell = ShapeCell("train_full", "train", tf["seq_len"],
                             tf["global_batch"])
            t0 = time.perf_counter()
            device = dryrun.fake_device("cuda")
            with dryrun.fake_group(1):
                mesh = init_device_mesh(device, (1, 1),
                                        mesh_dim_names=("data", "model"))
                pred = dryrun.measure_cell(cfg, cell, mesh, device=device,
                                           train_accum=tf["grad_accum"])
            pred_s = time.perf_counter() - t0
            cells = {}
            for (arch, shape), (t0, proc) in procs.items():
                log, _ = proc.communicate(timeout=900)
                name = f"{arch}__{shape}__pod1.json"
                res = json.loads((Path(d) / name).read_text())
                cpu = json.loads((dryrun.RESULTS_DIR / name).read_text())
                cells[f"{arch}/{shape}"] = {
                    "exit": proc.returncode,
                    "wall_s": time.perf_counter() - t0,
                    "log": log.strip().splitlines()[-2:],
                    **{k: res.get(k) for k in (
                        "ok", "device", "seconds", "tensor_parallel",
                        "kv_share", "flops_per_device",
                        "flops_over_model_flops_per_chip", "fits_h100",
                        "error")},
                    "peak_bytes": res.get("memory", {}).get("peak_bytes"),
                    "roofline": {k: res.get("roofline", {}).get(k) for k in
                                 ("compute_s", "memory_s", "collective_s",
                                  "bound", "collective_breakdown")},
                    "vs_cpu": {"device": cpu["device"], **{
                        k: res.get(k) == cpu.get(k) for k in (
                            "flops_per_device", "collective_counts")},
                        "collectives": res.get("roofline", {}).get(
                            "collective_breakdown") ==
                        cpu["roofline"]["collective_breakdown"],
                        "bytes": res.get("roofline", {}).get(
                            "bytes_per_device") ==
                        cpu["roofline"]["bytes_per_device"],
                        "peak": res.get("memory", {}).get("peak_bytes") ==
                        cpu["memory"]["peak_bytes"]}}
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    out["cells"] = cells
    terms = rf.roofline_from_terms(
        flops_per_device=pred["flops"], bytes_per_device=pred["bytes"],
        collective_breakdown=pred["collectives"], chips=1,
        model_flops_total=6 * cfg.param_count() * tf["global_batch"] *
        tf["seq_len"])
    bound_s = max(terms.compute_s, terms.memory_s, terms.collective_s)
    counted = full["counted_step"]["flops"]
    tr = full["train"]
    out["train_full_cell"] = {
        "model": cfg.name, **tf, "predict_s": pred_s,
        "predicted_flops": pred["flops"], "card_flops": counted,
        "flops_rel_err": abs(pred["flops"] - counted) / counted,
        "predicted_peak_bytes": pred["peak_bytes"],
        "predicted_argument_bytes": pred["argument_bytes"],
        "card_max_memory_allocated": tr["max_memory_allocated"],
        "memory_ratio": tr["max_memory_allocated"] / pred["peak_bytes"],
        "roofline": terms.to_dict(), "bound_s": bound_s,
        "step_s_p50": tr["step_s_p50"],
        "share_of_bound": bound_s / tr["step_s_p50"],
        "compute_share": terms.compute_s / tr["step_s_p50"]}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    for name, c in cells.items():
        check(c["exit"] == 0 and c["ok"],
              f"dryrun: {name} ran ok: {c['log']} {c.get('error')}")
        check(c["vs_cpu"]["flops_per_device"] and c["vs_cpu"]["collectives"],
              f"dryrun: {name}'s FLOPs and collective bytes on fake CUDA "
              f"tensors equal the CPU's: {c['vs_cpu']}")
    check(out["train_full_cell"]["flops_rel_err"] <= DRYRUN_FLOPS_RTOL,
          "dryrun: the predicted FLOPs of train_full's step equal the "
          f"card's count: {pred['flops']} vs {counted}")
    return out


def train_parity_phase(args, torch, dev, smi) -> dict:
    """minicpm-2b at full width and ``TRAIN_PARITY["n_layers"]`` layers in
    float32 (TF32 off).  (a) One ``make_train_step`` on the card against
    the same step on the CPU from the same parameters and batch (2
    micro-batches, WSD): ``loss`` and ``grad_norm`` within
    ``TRAIN_PARITY_RTOL`` (gated; float32 sums in another order), the
    parameters' largest difference reported.  (b) Resume: a Trainer runs
    4 steps in one go; another runs 2, checkpoints, and a fresh Trainer
    resumes for 2 more.  Gated: the resumed run reaches step 4 and its
    parameters differ from the unbroken run's by at most
    ``TRAIN_RESUME_RTOL`` of the 4 steps' update (norms over every
    parameter): bit equality is not required, the card's kernels may
    accumulate in another order from run to run."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, Trainer, make_train_step

    tp = TRAIN_PARITY
    cfg = get_config(TRAIN_ARCH).with_(
        n_layers=tp["n_layers"], param_dtype="float32",
        compute_dtype="float32")
    n = cfg.param_count()
    out = {"phase": "train_parity", "nvidia_smi": smi, "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab_size": cfg.vocab_size, "dtype": "float32",
           "allow_tf32": False, "params": n, **tp,
           "disk": need_disk(scratch_dir(), 3 * n * 12, "train_parity")}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    handlers = saved_signal_handlers()
    ckdir = tempfile.mkdtemp(prefix="train_parity.", dir=scratch_dir())
    try:
        tc = TrainConfig(lr=tp["lr"], warmup_steps=1, total_steps=10,
                         schedule="wsd", grad_accum=tp["grad_accum"],
                         seed=args.seed, checkpoint_every=100)
        # (a) card against CPU
        card = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           dev)
        host = Transformer(cfg, "cpu")
        host.load_state_dict(card.state_dict())
        tokens = TokenPipeline(cfg.vocab_size, tp["global_batch"],
                               tp["seq_len"], seed=args.seed).batch(0)[
                                   "tokens"]
        step = make_train_step(cfg, tc)
        res = {}
        for name, model in (("cuda", card), ("cpu", host)):
            opt = adamw_init(dict(model.named_parameters()))
            t0 = time.perf_counter()
            _, opt, m = step(model, opt, {"tokens": torch.from_numpy(
                tokens).to(model.device)})
            res[name] = {k: float(v) for k, v in m.items()}
            res[name]["seconds"] = time.perf_counter() - t0
        diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                   for a, b in zip(card.parameters(), host.parameters()))
        out["step"] = {**res, "params_max_abs_diff": diff,
                       "rtol": TRAIN_PARITY_RTOL}
        del card, host, opt
        torch.cuda.empty_cache()

        # (b) resume against an unbroken run
        def trainer(sub):
            return Trainer(cfg, TrainConfig(**{
                **tc.__dict__, "checkpoint_dir": str(Path(ckdir) / sub)}),
                dev, tp["global_batch"], tp["seq_len"])

        whole = trainer("whole")
        t0 = time.perf_counter()
        whole.run(4, log_every=0)
        whole_s = time.perf_counter() - t0
        init, _ = whole.init_state()
        trainer("split").run(2, log_every=0)
        resumed = trainer("split")
        resumed.run(2, log_every=0)
        def sq(ts):
            return sum(float(t.double().square().sum()) for t in ts)

        final, again = (list(t.model.parameters()) for t in (whole,
                                                             resumed))
        with torch.no_grad():
            gap = math.sqrt(sq(a - b for a, b in zip(final, again)))
            update = math.sqrt(sq(a - b for a, b in zip(
                final, init.parameters())))
            max_diff = max(float((a - b).abs().max())
                           for a, b in zip(final, again))
        out["resume"] = {
            "steps": [whole.step, resumed.step],
            "opt_steps": [whole.opt.step, resumed.opt.step],
            "bit_equal": all(torch.equal(a, b) for a, b in zip(final,
                                                                again)),
            "max_abs_diff": max_diff,
            "diff_norm": gap, "update_norm": update,
            "relative": gap / update, "rtol": TRAIN_RESUME_RTOL,
            "whole_run_s": whole_s,
            "checkpoint_bytes": dir_bytes(Path(ckdir) / "split")}
        del whole, resumed, init, final, again
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        restore_signal_handlers(handlers)
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(out)
    st = out["step"]
    for k in ("loss", "grad_norm"):
        check(math.isfinite(st["cuda"][k]) and
              math.isclose(st["cuda"][k], st["cpu"][k],
                           rel_tol=TRAIN_PARITY_RTOL),
              f"train_parity: {k} on the card == on the CPU "
              f"({st['cuda'][k]} vs {st['cpu'][k]})")
    r = out["resume"]
    check(r["steps"] == [4, 4] and r["opt_steps"] == [4, 4],
          f"train_parity: the resumed run reaches step 4: {r['steps']}")
    check(r["relative"] <= TRAIN_RESUME_RTOL,
          f"train_parity: resumed == unbroken run ({r['relative']})")
    return out


def sharded_train_phase(args, torch, dev, smi, full: dict) -> dict:
    """The sharded trainer on the card: a one-rank NCCL process group
    (started here from a FileStore under ``build/``, destroyed after) and
    the host mesh (data 1, model 1).  (a) minicpm-2b at full width and
    ``TRAIN_PARITY``'s layers in float32 (TF32 off): one step of
    ``Trainer(mesh=)`` against the one-device ``Trainer``'s from the same
    seed and batch.  Gated: ``loss`` and ``grad_norm`` within
    ``SHARDED_STEP_RTOL`` and every parameter within it absolutely; every
    parameter's and moment's placements the rule table's
    (``train/sharding.py``).  (b) minicpm-2b at full size in bf16 through
    ``launch/train.py``'s ``build``, which takes the group's mesh:
    ``SHARDED_TRAIN`` steps with the final checkpoint (gathered, rank 0
    writing; removed after).  Gated: the trainer is on the mesh, every
    loss and grad norm finite, the checkpoint written.  Reported: step
    p50, tokens/s and peak memory beside ``train_full``'s."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train import TrainConfig, Trainer

    tp = TRAIN_PARITY
    cfg = get_config(TRAIN_ARCH).with_(
        n_layers=tp["n_layers"], param_dtype="float32",
        compute_dtype="float32")
    big = get_config(TRAIN_ARCH)
    st = SHARDED_TRAIN
    tokens = st["global_batch"] * st["seq_len"]
    out = {"phase": "sharded_train", "nvidia_smi": smi,
           "device_count": torch.cuda.device_count(), "backend": "nccl",
           "world_size": 1, "mesh": {"data": 1, "model": 1},
           "disk": need_disk(scratch_dir(), big.param_count() * 10,
                             "sharded_train")}
    ckdir = tempfile.mkdtemp(prefix="sharded_train.", dir=scratch_dir())
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    handlers = saved_signal_handlers()
    try:
        with one_rank_group(torch, dev) as mesh:
            # (a) the (1, 1) mesh's step against the one-device step
            torch.backends.cuda.matmul.allow_tf32 = False
            tc = TrainConfig(lr=tp["lr"], warmup_steps=1, total_steps=10,
                             schedule="wsd", grad_accum=tp["grad_accum"],
                             seed=args.seed, checkpoint_dir=ckdir,
                             checkpoint_every=100)
            t = Trainer(cfg, tc, dev, tp["global_batch"], tp["seq_len"])
            model, opt = t.init_state()
            batch = t.batch(0)
            t0 = time.perf_counter()
            model, opt, metrics = t.train_step(model, opt, batch)
            torch.cuda.synchronize()
            one = {k: float(v) for k, v in metrics.items()}
            one["seconds"] = time.perf_counter() - t0
            del opt, t
            ms = mesh_step(torch, dev, mesh, cfg, tc, batch, model)
            del model
            out["placements"] = ms["placements"]
            out["step"] = {"one_device": one, "mesh": ms["step"],
                           "params_max_abs_diff": ms["params_max_abs_diff"],
                           "bit_equal": ms["bit_equal"],
                           "rtol": SHARDED_STEP_RTOL,
                           "n_layers": cfg.n_layers, "dtype": "float32"}
            torch.backends.cuda.matmul.allow_tf32 = prev_tf32
            torch.cuda.empty_cache()

            # (b) full size through the launcher, on the group's mesh
            trainer, _ = launch_train.build([
                "--arch", TRAIN_ARCH, "--steps", str(st["steps"]),
                "--global-batch", str(st["global_batch"]),
                "--seq-len", str(st["seq_len"]), "--checkpoint-dir", ckdir,
                "--checkpoint-every", str(10 * st["steps"]),
                "--device", str(dev)])
            on_mesh = trainer.mesh is not None and \
                tuple(trainer.mesh.shape) == (1, 1)
            saves = timed_saves(trainer)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            hist = trainer.run(st["steps"], log_every=0)
            run_s = time.perf_counter() - t0
            step_s = np.asarray([h["seconds"] for h in hist[1:]])
            p50 = float(np.median(step_s))
            ft = full["train"]
            out["train"] = {
                "model": big.name, "params": big.param_count(), **st,
                "on_mesh": on_mesh, "loss": [h["loss"] for h in hist],
                "grad_norm": [h["grad_norm"] for h in hist],
                "first_step_s": hist[0]["seconds"], "step_s_p50": p50,
                "tokens_per_s": tokens / p50, "run_s": run_s,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "checkpoint": {"bytes": dir_bytes(ckdir), "saves": [
                    {"seconds": s, "step": k} for s, k in saves]},
                "train_full": {
                    "step_s_p50": ft["step_s_p50"],
                    "tokens_per_s": ft["tokens_per_s"],
                    "max_memory_allocated": ft["max_memory_allocated"],
                    "global_batch": full["global_batch"],
                    "seq_len": full["seq_len"],
                    "grad_accum": full["grad_accum"]}}
            del trainer
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        restore_signal_handlers(handlers)
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(out)
    s = out["step"]
    for k in ("loss", "grad_norm"):
        check(math.isfinite(s["mesh"][k]) and math.isclose(
            s["mesh"][k], s["one_device"][k], rel_tol=SHARDED_STEP_RTOL),
            f"sharded_train: {k} on the (1, 1) mesh == one device "
            f"({s['mesh'][k]} vs {s['one_device'][k]})")
    check(s["params_max_abs_diff"] <= SHARDED_STEP_RTOL,
          f"sharded_train: parameters on the mesh == one device "
          f"({s['params_max_abs_diff']})")
    check(not out["placements"]["wrong"],
          f"sharded_train: every leaf takes the rule table's placements: "
          f"{out['placements']}")
    tr = out["train"]
    check(tr["on_mesh"], "sharded_train: launch.train built the mesh")
    check(len(tr["loss"]) == st["steps"] and
          all(math.isfinite(v) for v in tr["loss"] + tr["grad_norm"]),
          f"sharded_train: {st['steps']} finite steps at full size")
    check(tr["checkpoint"]["saves"] and
          tr["checkpoint"]["saves"][-1]["step"] == st["steps"],
          "sharded_train: the final checkpoint was written")
    return out


def train_families_phase(args, torch, dev, smi) -> None:
    """The MoE, SSM, hybrid, VLM and audio families trained at full width
    on the card, one line each (:func:`train_family_case`), one model at
    a time and freed between them; a last line with the phase's K1/K2/K3
    launches, which must be 0: the families' dispatch and scans are
    plain PyTorch, as they are XLA in the reference."""
    from repro_torch.kernels.logic_dsp import kernel as K

    K.reset_launch_counts()                     # the phase's path
    t0 = time.perf_counter()
    for arch, plan in TRAIN_FAMILIES.items():
        train_family_case(args, torch, dev, smi, arch, plan)
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    emit({"phase": "train_families", "models": list(TRAIN_FAMILIES),
          "launches": launches, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    check(not any(launches.values()),
          f"train_families: no ported kernel on the path: {launches}")


def allocated_params(cfg) -> int:
    """The elements the model allocates (its padded vocabulary's rows
    included)."""
    from repro_torch.train import sharding as shd
    tree = shd.param_shapes(cfg, "layers")
    return sum(v.numel() for k, v in tree.items() if k != "layers") + sum(
        v.numel() for layer in tree["layers"] for v in layer.values())


def active_params(cfg, n: int) -> int:
    """The parameters a token passes through: for MoE the router and k of
    the E experts of each layer."""
    if cfg.family != "moe":
        return n
    idle = cfg.n_experts - cfg.experts_per_token
    return n - cfg.n_layers * 3 * idle * cfg.d_model * cfg.d_ff


def train_batch(torch, cfg, rows: int, positions: int, vision: int,
                seed: int, step: int, dev) -> dict:
    """Step ``step``'s seeded batch of the family's training inputs on
    ``dev``, ``rows`` x ``positions``: tokens (``TokenPipeline``); for vlm
    ``vision`` stub patch embeddings before the tokens; for audio frames
    and their labels."""
    from repro_torch.data import TokenPipeline
    g = torch.Generator(dev).manual_seed(seed * 1000 + step)
    if cfg.family == "audio":
        return {"frames": torch.randn((rows, positions, cfg.frontend_dim),
                                      generator=g, device=dev),
                "labels": torch.randint(0, cfg.vocab_size, (rows, positions),
                                        generator=g, device=dev)}
    n_text = positions - (vision if cfg.family == "vlm" else 0)
    out = {"tokens": torch.from_numpy(TokenPipeline(
        cfg.vocab_size, rows, n_text, seed=seed).batch(step)["tokens"]
    ).to(dev)}
    if cfg.family == "vlm":
        out["vision"] = torch.randn((rows, vision, cfg.d_model),
                                    generator=g, device=dev)
    return out


def train_family_case(args, torch, dev, smi, arch, plan) -> dict:
    """One family trained at full width in bf16 (the config's moment
    dtype and remat), random weights from ``--seed``: (a)
    ``TRAIN_FAMILY["steps"]`` steps of 8 x 512 positions through
    ``launch/train.py``'s Trainer with its final checkpoint (written
    under build/ after a free-disk check, removed after) or through
    ``make_train_step`` on explicit batches, then one step profiled;
    (b) on one fixed batch the run has not seen, from fresh AdamW state
    (``TRAIN_FAMILY_DESCENT``), the loss after 4 steps below the first;
    (c) a float32 step (TF32 off) at ``plan["parity"]`` layers and full
    width on 2 x 64 positions, card against CPU within
    ``TRAIN_FAMILY_PARITY_TOL`` on the loss, the grad norm and every
    parameter; (d) for mixtral that step on a one-rank NCCL (1, 1) mesh
    against one device within ``SHARDED_STEP_RTOL``.  Gated: every loss
    and grad norm finite, (b), (c), (d), the checkpoint written.
    Reported: parameters and active parameters, step p50/p90, tokens/s,
    MFU (6 N_active tokens over the step at the bf16 peak), peak memory,
    the profiled step's launches and the device's idle share, and for
    MoE each layer's dropped assignments on the last batch."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw_init, resolve_moment_dtype
    from repro_torch.train import TrainConfig, make_train_step

    whole = get_config(arch)
    cfg = whole.with_(n_layers=plan["layers"] or whole.n_layers)
    tf = TRAIN_FAMILY
    rows, positions = tf["global_batch"], tf["seq_len"]
    vision = plan.get("vision", 0)
    n = allocated_params(cfg)
    n_active = active_params(cfg, n)
    tokens = rows * positions
    moment_bytes = resolve_moment_dtype(cfg.moment_dtype).itemsize
    t_case = time.perf_counter()
    out = {"phase": "train_families", "model": cfg.name,
           "family": cfg.family, "nvidia_smi": smi, "route": (
               "launch.train.build" if plan["route"] == "launcher"
               else "make_train_step"),
           "config": {k: getattr(cfg, k) for k in (
               "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
               "vocab_size", "n_experts", "experts_per_token",
               "capacity_factor", "param_dtype", "moment_dtype", "remat")},
           "params": n, "active_params": n_active, **tf,
           "positions_per_step": tokens, "vision_positions": vision,
           "reduced": {}}
    if cfg.n_layers < whole.n_layers:
        out["reduced"] = {"n_layers": cfg.n_layers, "of": whole.n_layers,
                          "params_whole": allocated_params(whole)}
    def batch(step):
        return train_batch(torch, cfg, rows, positions, vision, args.seed,
                           step, dev)

    handlers = saved_signal_handlers()
    ckdir = None
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if plan["route"] == "launcher":
            ckpt_need = n * (2 + 2 * moment_bytes)
            out["disk"] = need_disk(scratch_dir(), ckpt_need, cfg.name)
            ckdir = tempfile.mkdtemp(prefix="train_families.",
                                     dir=scratch_dir())
            trainer, _ = launch_train.build([
                "--arch", arch, "--steps", str(tf["steps"]),
                "--global-batch", str(rows), "--seq-len", str(positions),
                "--checkpoint-dir", ckdir,
                "--checkpoint-every", str(10 * tf["steps"]),
                "--device", str(dev)])
            check(trainer.cfg == cfg, f"{cfg.name}: the launcher's config")
            saves = timed_saves(trainer)
            hist = trainer.run(tf["steps"], log_every=0)
            model, opt, step = trainer.model, trainer.opt, trainer.train_step
            last = trainer.batch(trainer.step)
            out["checkpoint"] = {"bytes": dir_bytes(ckdir), "saves": [
                {"seconds": t, "step": st} for t, st in saves],
                "expected_bytes": ckpt_need}
            shutil.rmtree(ckdir, ignore_errors=True)
            del trainer
        else:
            model = init_params(cfg, torch.Generator(dev).manual_seed(
                args.seed), dev)
            step = make_train_step(cfg, TrainConfig(
                lr=3e-4, warmup_steps=1, total_steps=tf["steps"]))
            opt = adamw_init(dict(model.named_parameters()),
                             resolve_moment_dtype(cfg.moment_dtype))
            hist = []
            for i in range(tf["steps"]):
                b = batch(i)
                t1 = time.perf_counter()
                model, opt, m = step(model, opt, b)
                m = {k: float(v) for k, v in m.items()}
                hist.append({**m, "seconds": time.perf_counter() - t1})
            last = batch(tf["steps"])
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        step_s = np.asarray([h["seconds"] for h in hist[1:]])
        p50 = float(np.median(step_s))
        out["train"] = {
            "lr": [h["lr"] for h in hist], "loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "first_step_s": hist[0]["seconds"], "step_s_p50": p50,
            "step_s_p90": float(np.percentile(step_s, 90)),
            "tokens_per_s": tokens / p50,
            "mfu": 6 * n_active * tokens / p50 / BF16_FLOPS_PER_S,
            "floor_ms_6nt": 6 * n_active * tokens / BF16_FLOPS_PER_S * 1e3,
            "run_s": run_s, "max_memory_allocated": peak,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "moment_bytes": sum(m.numel() * m.element_size() for m in
                                (*opt.mu.values(), *opt.nu.values()))}
        out["profiled_step"] = profile_step(
            torch, lambda: step(model, opt, last))
        if cfg.family == "moe":
            with torch.no_grad():       # the model's weights train
                routes = moe_routing(torch, model, last["tokens"])
            out["moe"] = {
                "capacity": routes[0][2],
                "assignments_per_layer": int(routes[0][0].numel()),
                "dropped_by_layer": [int((slot == cfg.n_experts * cap).sum())
                                     for _, slot, cap in routes]}
        # (b) the loss falls on one fixed batch from fresh AdamW state
        opt = None
        opt = adamw_init(dict(model.named_parameters()),
                         resolve_moment_dtype(cfg.moment_dtype))
        fd = TRAIN_FAMILY_DESCENT
        descend = make_train_step(cfg, TrainConfig(lr=fd["lr"],
                                                   schedule="const"))
        fixed = batch(fd["batch"])
        descent = []
        for _ in range(TRAIN_DESCENT_STEPS):
            model, opt, m = descend(model, opt, fixed)
            descent.append(float(m["loss"]))
        out["descent"] = {**fd, "loss": descent}
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        del model, opt, step, last, fixed
    finally:
        restore_signal_handlers(handlers)
        if ckdir:
            shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) float32, card against CPU; (d) mixtral on the (1, 1) mesh
    fp = TRAIN_FAMILY_PARITY
    c32 = whole.with_(n_layers=plan["parity"], param_dtype="float32",
                      compute_dtype="float32")
    tc = TrainConfig(lr=fp["lr"], schedule="const", seed=args.seed,
                     checkpoint_dir=str(scratch_dir()))
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    handlers = saved_signal_handlers()
    try:
        t0 = time.perf_counter()
        card = init_params(c32, torch.Generator(dev).manual_seed(args.seed),
                           dev)
        host = Transformer(c32, "cpu")
        host.load_state_dict(card.state_dict())
        pb = train_batch(torch, c32, fp["global_batch"], fp["seq_len"],
                         fp["vision"], args.seed, 0, dev)
        step = make_train_step(c32, tc)
        res = {}
        for name, model in (("cuda", card), ("cpu", host)):
            opt = adamw_init(dict(model.named_parameters()),
                             resolve_moment_dtype(c32.moment_dtype))
            t1 = time.perf_counter()
            _, opt, m = step(model, opt, {k: v.to(model.device)
                                          for k, v in pb.items()})
            res[name] = {k: float(v) for k, v in m.items()}
            res[name]["seconds"] = time.perf_counter() - t1
        del model, opt
        with torch.no_grad():
            diffs = [(a.detach().cpu() - b.detach()).abs()
                     for a, b in zip(card.parameters(), host.parameters())]
        out["parity"] = {
            **res, "n_layers": c32.n_layers, "params": allocated_params(c32),
            "dtype": "float32", "allow_tf32": False, **fp,
            "params_max_abs_diff": max(float(d.max()) for d in diffs),
            "params_past_1e-5": sum(int((d > 1e-5).sum()) for d in diffs),
            "tol": TRAIN_FAMILY_PARITY_TOL,
            "seconds": time.perf_counter() - t0}
        del host, diffs
        if plan.get("mesh"):
            with one_rank_group(torch, dev) as mesh:
                out["mesh"] = {"backend": "nccl", "mesh": {"data": 1,
                                                           "model": 1},
                               **mesh_step(torch, dev, mesh, c32, tc, pb,
                                           card)}
        del card
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        restore_signal_handlers(handlers)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_case
    emit(out)

    name, tr = cfg.name, out["train"]
    check(len(tr["loss"]) == tf["steps"] and all(
        math.isfinite(v) for v in tr["loss"] + tr["grad_norm"] + descent),
          f"{name}: every loss and grad norm is finite")
    check(descent[-1] < descent[0],
          f"{name}: the fixed-batch loss falls: {descent}")
    pa, tol = out["parity"], TRAIN_FAMILY_PARITY_TOL
    for k in ("loss", "grad_norm"):
        check(math.isclose(pa["cuda"][k], pa["cpu"][k], rel_tol=tol),
              f"{name}: float32 {k} on the card == on the CPU "
              f"({pa['cuda'][k]} vs {pa['cpu'][k]})")
    check(pa["params_max_abs_diff"] <= tol,
          f"{name}: float32 parameters on the card == on the CPU "
          f"({pa['params_max_abs_diff']})")
    if "mesh" in out:
        ms = out["mesh"]
        for k in ("loss", "grad_norm"):
            check(math.isclose(ms["step"][k], pa["cuda"][k],
                               rel_tol=SHARDED_STEP_RTOL),
                  f"{name}: {k} on the (1, 1) mesh == one device")
        check(ms["params_max_abs_diff"] <= SHARDED_STEP_RTOL and
              not ms["placements"]["wrong"],
              f"{name}: the (1, 1) mesh's step == one device's: {ms}")
    if "checkpoint" in out:
        check(out["checkpoint"]["saves"] and
              out["checkpoint"]["saves"][-1]["step"] == tf["steps"],
              f"{name}: the final checkpoint was written")
    return out


@contextlib.contextmanager
def one_rank_group(torch, dev):
    """A one-rank NCCL process group (from a FileStore under build/) and
    its host mesh (data 1, model 1); the group is destroyed and its store
    removed on exit."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    store = Path(tempfile.mkdtemp(prefix="nccl_group.", dir=scratch_dir()))
    dist.init_process_group("nccl", store=dist.FileStore(
        str(store / "store"), 1), rank=0, world_size=1, device_id=dev)
    try:
        yield make_host_mesh(model=1, device=dev)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def mesh_step(torch, dev, mesh, cfg, tc, batch, one_device) -> dict:
    """``Trainer(mesh=)``'s first step on ``batch``, from the seed
    (``tc.seed``) that ``one_device`` was drawn from, against
    ``one_device`` after its own step: the mesh step's metrics, the
    largest parameter difference, bit equality, and the parameters and
    moments whose placements are not the rule table's."""
    from repro_torch.models.pspec_utils import mesh_axes, placements
    from repro_torch.train import Trainer
    from repro_torch.train import sharding as shd

    rows, seq = next(iter(batch.values())).shape[:2]
    t = Trainer(cfg, tc, dev, rows, seq, mesh=mesh)
    model, opt = t.init_state()
    t0 = time.perf_counter()
    model, opt, m = t.train_step(model, opt, batch)
    torch.cuda.synchronize()
    res = {k: float(v) for k, v in m.items()}
    res["seconds"] = time.perf_counter() - t0
    mine = dict(one_device.named_parameters())
    want = shd.flat_param_pspecs(cfg, mesh_axes(mesh))
    want_m = shd.flat_moment_pspecs(cfg, mesh_axes(mesh))
    wrong = [k for k, d in model.params.items()
             if tuple(d.placements) != placements(mesh, want[k])
             or tuple(opt.mu[k].placements) != placements(mesh, want_m[k])]
    return {"step": res,
            "params_max_abs_diff": max(
                float((d.to_local() - mine[k].detach()).abs().max())
                for k, d in model.params.items()),
            "bit_equal": all(torch.equal(d.to_local(), mine[k])
                             for k, d in model.params.items()),
            "placements": {
                "leaves": len(model.params), "wrong": wrong[:5],
                **{k: [str(p) for p in model.params[k].placements]
                   for k in ("blocks.0.wq", "embed")}}}


def logic_swap_train_phase(args, torch, dev, smi, cuda_ms) -> dict:
    """The paper's technique in a trained LM on the card: the port's
    ``examples/logic_mlp_swap`` flow at the reference example's widths
    (2 layers, d_model 48, d_ff 24, vocab 256): STE training (150 steps,
    lr 2e-3, ``TokenPipeline(256, 8, 32)``), the FFN inputs captured from
    8 calibration batches (900..907), ``ffn_to_program`` at ``n_unit``
    16, then the logic model (K1 for every FFN's hidden layer) on the
    calibration batches and the held-out batch 1234.  Gated: K1 launched
    once per layer and batch; its hidden bits equal the plain executor's
    and ``binary_hidden``'s in both layers on every calibration batch; the
    logits equal the STE model's there (1e-6).  Reported: the loss before
    and after training, gates and steps per layer, conversion seconds,
    K1's device ms per call, and the held-out loss and argmax agreement,
    STE against logic, beside the untrained ``logic_ffn`` phase's."""
    import numpy as np

    from repro_torch.examples import logic_mlp_swap as swap
    from repro_torch.kernels.logic_dsp import kernel as K
    from repro_torch.kernels.logic_dsp import ops
    from repro_torch.models import logic_mlp

    cfg = swap.swap_config()
    model = swap.init_swap_model(cfg, args.seed, dev)
    pipe = swap.pipeline(cfg, args.seed)
    t0 = time.perf_counter()
    losses = swap.train_ste(model, pipe, swap.STEPS, swap.LR,
                            log=lambda *_: None)
    train_s = time.perf_counter() - t0
    calib = [swap.tokens_of(pipe, swap.CALIB_FIRST + i, dev)
             for i in range(swap.CALIB_BATCHES)]
    held_tokens = swap.tokens_of(pipe, swap.HELD_OUT, dev)
    t0 = time.perf_counter()
    layers = swap.convert(model, swap.capture_bits(model, calib),
                          log=lambda *_: None)
    convert_s = time.perf_counter() - t0
    programs = [blk.program for blk in model.blocks]

    t0 = time.perf_counter()
    K.reset_launch_counts()                 # trained logic path starts here
    logic, logic_inputs = [], []
    for tokens in calib:
        ins = []
        logic.append(swap.forward_with(model, tokens, programs,
                                       ffn_inputs=ins))
        logic_inputs.append(ins)
    held_inputs = []
    swap.forward_with(model, held_tokens, programs, ffn_inputs=held_inputs)
    torch.cuda.synchronize()
    launches = {k: K.launch_count(k) for k in ("logic", "mega", "xnor")}
    wall_s = time.perf_counter() - t0        # trained logic path ends here

    d = cfg.d_model
    err, hidden_equal = 0, True
    with torch.inference_mode():
        for ins in logic_inputs:
            for blk, h in zip(model.blocks, ins):
                words = ops.pack_bits((h.float() >= 0).reshape(-1, d))
                k1 = ops.logic_forward(blk.program, words)
                err = max(err, word_err(k1, ops.logic_forward(
                    blk.program, words, use_ref=True)))
                hidden = ops.unpack_bits(k1, h.shape[0] * h.shape[1])
                hidden_equal &= torch.equal(
                    hidden, logic_mlp.binary_hidden(blk.params(), h))
    ste = [swap.forward_with(model, t, [None] * len(programs))
           for t in calib]
    logit_err = max(float((a - b).abs().max()) for a, b in zip(logic, ste))
    held = swap.compare(model, programs, held_tokens)

    prog = programs[0]
    words = ops.pack_bits((held_inputs[0].float() >= 0).reshape(-1, d))
    a = ops.program_arrays(prog, dev)
    k1_call = (lambda: K.logic_cuda_call(a["rec"], words, a["output_addrs"],
                                         n_addr=prog.n_addr, plan=a["plan"]))
    out = {"phase": "logic_swap_train", "nvidia_smi": smi,
           "model": f"{cfg.name} at the logic_mlp_swap widths",
           "config": {k: getattr(cfg, k) for k in swap.SWAP},
           "steps": swap.STEPS, "lr": swap.LR, "train_s": train_s,
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_last10_mean": float(np.mean(losses[-10:])),
           "calibration_batches": swap.CALIB_BATCHES, "n_unit": swap.N_UNIT,
           "layers": layers, "convert_s": convert_s,
           "hidden_bits_equal": hidden_equal, "max_abs_err": err,
           "tolerance": 0, "logits_max_abs_diff": logit_err,
           "logits_tolerance": 1e-6, "held_out": held,
           "k1_words": words.shape[1],
           "k1_device_ms": device_ms_per_call(torch, k1_call, 50),
           "k1_plain_ms": cuda_ms(lambda: ops.logic_forward(
               prog, words, use_ref=True), 3, warmup=1),
           "k1_scratch": a["plan"].scratch, "wall_s": wall_s,
           "launches": launches}
    emit(out)
    check(all(math.isfinite(v) for v in losses),
          "logic_swap_train: every STE loss is finite")
    check(err == 0 and hidden_equal,
          "logic_swap_train: K1's hidden bits == plain == binary_ffn's")
    check(logit_err <= 1e-6,
          f"logic_swap_train: logits == the STE model's ({logit_err})")
    check(launches["logic"] == cfg.n_layers * (swap.CALIB_BATCHES + 1) and
          launches["mega"] == 0,
          f"logic_swap_train: one K1 launch per layer and batch: {launches}")
    return out


def decode_step_host_profile(torch, model, cache, dev) -> dict:
    """One more decode step under torch.profiler: the kernels it launches,
    the host's wall time for it (profiled), and the operators with the
    most host time (ms), largest first."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import decode_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = decode_step(model, torch.tensor([[0]], device=dev),
                                cache)
        int(torch.argmax(logits[0, -1]))
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    launches = sum(a.count for a in avgs
                   if "LaunchKernel" in a.key or a.key == "cudaMemcpyAsync")
    top = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                  for a in avgs), key=lambda t: -t[1])[:8]
    return {"kernel_launches": launches, "wall_ms": wall_ms,
            "host_ms_by_op": {k: {"ms": ms, "calls": n} for k, ms, n in top}}


def scratch_dir() -> Path:
    """Where the phases' temporary stores live: the checkout's build/."""
    d = ROOT / "build" / "chip_smoke"
    d.mkdir(parents=True, exist_ok=True)
    return d


def traced(torch, fn):
    """Run ``fn`` under torch.profiler; returns the wall time (us), the
    union of the device's busy intervals (us; None when the trace holds no
    device work), device time by kernel name (ms; see
    :func:`device_busy`) and the kernel launches the host made."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name = device_busy(prof)
    launches = sum(a.count for a in prof.key_averages()
                   if "LaunchKernel" in a.key)
    return wall_us, busy_us, by_name, launches


def device_busy(prof):
    """The union of the device's busy intervals in a profiler trace (us;
    None when it holds no device work) and device time by kernel name
    (ms, largest first).  The profiler's own "Activity Buffer Request"
    spans are not device work and are left out."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.name != "Activity Buffer Request")
    busy_us, lo, hi = 0.0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            busy_us += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy_us += 0.0 if hi is None else hi - lo
    by_name = sorted(((a.key, a.self_device_time_total / 1e3)
                      for a in prof.key_averages()
                      if a.self_device_time_total > 0
                      and a.key != "Activity Buffer Request"),
                     key=lambda kv: -kv[1])
    return (busy_us if spans else None), by_name


def profile_waves(torch, serve_all) -> dict:
    """Trace ``serve_all`` (one call per wave): wall time, the device's busy
    time and idle share, the mega kernel's device time per wave, and
    device time by kernel name (the five largest)."""
    waves = []
    wall_us, busy_us, by_name, _ = traced(
        torch, lambda: waves.extend(serve_all()))
    kernel_ms = sum(ms for name, ms in by_name if "mega_kernel" in name)
    return {"waves": len(waves), "wall_ms": wall_us / 1e3,
            "device_busy_ms": None if busy_us is None else busy_us / 1e3,
            "device_idle_share": (None if busy_us is None
                                  else 1 - busy_us / wall_us),
            "kernel_device_ms_per_wave": kernel_ms / len(waves),
            "device_ms_by_name": dict(by_name[:5])}


def device_ms_per_call(torch, fn, calls: int) -> float | None:
    """The device's busy time per call of ``fn`` over ``calls`` calls back
    to back (profiler trace), after one untraced warm-up call."""
    fn()
    _, busy_us, _, _ = traced(torch, lambda: [fn() for _ in range(calls)])
    return None if busy_us is None else busy_us / 1e3 / calls


def variant_counts(K) -> dict:
    """K1's and K2's launches so far by scratch variant, as
    ``{"logic/shared": n, ...}``."""
    return {f"{k}/{v}": K.launch_count(k, v) for k in ("logic", "mega")
            for v in ("shared", "device")}


def tensor_core_sass(lib_path, kernel: str) -> dict:
    """Tensor-core instructions in one kernel's SASS, by opcode, from
    ``cuobjdump --dump-sass`` of the built library."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "--dump-sass",
         str(lib_path)], capture_output=True, text=True, timeout=120,
        check=True).stdout
    counts, inside = {}, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside:
            for op in re.findall(TC_SASS, ln):
                counts[op] = counts.get(op, 0) + 1
    return counts


def artifact_of(engine):
    """The one artifact an engine's cache holds after serving one graph."""
    (key,) = list(engine.cache._entries)
    return engine.cache.peek(key).artifact


if __name__ == "__main__":
    sys.exit(main())
