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

Output, one JSON object per line: ``env``, ``build``, ``parity``,
``main_path``, ``timing``, ``engine``, ``xnor`` and ``flow``; then the
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
import json
import subprocess
import sys
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

    def word_err(a, b) -> int:
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

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
    check(bool((k1_out == artifact.execute(x_k1)).all()),
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

    xnor = xnor_phase(args, torch, dev, cuda_ms, smi)
    flow = flow_phase(torch, dev)
    paths = {"fc1": launches, "xnor": xnor["launches"],
             "flow": flow["launches"], "flow_default": flow["default"]["launches"]}
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


def traced(torch, fn):
    """Run ``fn`` under torch.profiler; returns the wall time (us), the
    union of the device's busy intervals (us; None when the trace holds no
    device work) and device time by kernel name (ms).  The profiler's own
    "Activity Buffer Request" spans are not device work and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    return wall_us, busy_us if spans else None, by_name


def profile_waves(torch, serve_all) -> dict:
    """Trace ``serve_all`` (one call per wave): wall time, the device's busy
    time and idle share, the mega kernel's device time per wave, and
    device time by kernel name (the five largest)."""
    waves = []
    wall_us, busy_us, by_name = traced(
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
    _, busy_us, _ = traced(torch, lambda: [fn() for _ in range(calls)])
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
