#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU (an H100 by design).

Run from the root of a checkout:  ``python3 chip_smoke.py``

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel bit-exactly against its plain PyTorch version on the card
and against the numpy oracle, then drives the serving path at full width:
a LeNet-5 ``fc1`` NullaNet layer (400 inputs, 120 neurons, each an ISF
sampled on 400 patterns; weights and patterns from ``--seed``) synthesized
with the port's ``layer_to_graph`` and served by ``LogicEngine`` through
the mega kernel, monolithic and as a 4-program parallel pipeline, plus the
monolithic program through ``logic_infer_bits`` (the single-program
kernel K1, launched as the mega kernel's one-stage case).  Finally it
times both kernels at the main path's shapes, and
the engine's waves (median and p90 of 100, a per-phase split from CUDA
events, and a torch.profiler window for the device's idle share).

Output, one JSON object per line: ``env``, ``build``, ``parity``,
``main_path``, ``timing`` and ``engine``; then the card's name and power
limit as nvidia-smi prints them; then a ``kernels`` line (per kernel: its
launches on the main path, its largest difference from the plain version,
its time, the plain version's time and the card's bound); and last
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
K1_REPLACES = "src/repro/kernels/logic_dsp/kernel.py:96"
K2_REPLACES = "src/repro/kernels/logic_dsp/kernel.py:204"
KERNEL_SOURCE = "src/repro_torch/csrc/logic_dsp.cu"
BATCHES = (1, 31, 32, 33, 70, 8192)
# LeNet-5 fc1 at the paper's geometry (benchmarks/workloads.py LENET5_LAYERS)
FANIN, NEURONS, ISF_SAMPLES = 400, 120, 400
CAPACITY = 8192                      # samples per engine wave
MAX_GATES = 12000                    # partition budget of the pipelined cell
TIMED_WAVES = 100                    # p90 of 100 waves has 10 beyond it


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
    ptxas = [ln.strip() for ln in K.build_info.get("ptxas", "").splitlines()
             if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": K.build_info["seconds"], "library":
          str(Path(K.build_info["path"]).relative_to(ROOT))
          if Path(K.build_info["path"]).is_relative_to(ROOT)
          else K.build_info["path"], "ptxas": ptxas})

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
        got = ops.forward_words(*args_, n_addr=a["n_addr"])
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
    emit({"phase": "parity", "cases": cases, "failed": failed,
          "tolerance": 0, "max_abs_err": max_err, "seconds": time.perf_counter() - t0,
          "failures": sorted(k for k, ok in results.items() if not ok)})
    check(failed == 0, f"{failed} kernel/plain parity cases failed")

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

    check(launches["logic"] == 1, "logic_infer_bits made one K1 launch")
    check(bool((k1_out == artifact.execute(x_k1)).all()),
          "K1 on the fc1 program matches the numpy oracle")
    main = {"phase": "main_path",
            "model": f"LeNet-5 fc1 ({FANIN} -> {NEURONS})",
            "gates": graph.n_gates, "synth_s": synth_s,
            "requests": list(sizes), "launches": launches}
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
    a1 = ops.program_arrays(prog, dev)
    k1_args = (a1["src_a"], a1["src_b"], a1["dst"], a1["opcode"],
               a1["step_branch"], a1["output_addrs"], words)

    def k1():
        return K.logic_cuda_call(*k1_args[:5], words, a1["output_addrs"],
                                 n_addr=prog.n_addr)

    def k1_plain():
        return ops.forward_words(*k1_args, n_addr=prog.n_addr, use_ref=True)

    max_err["logic"] = max(max_err["logic"], word_err(k1(), k1_plain()))

    def mega_call(mega):
        m = ops.mega_arrays(mega, dev)
        return K.mega_cuda_call(
            m["src_a"], m["src_b"], m["dst"], m["opcode"], m["step_branch"],
            words, m["stage_table"], m["out_addrs"], m["out_rows"],
            n_addr=mega.n_addr, n_outputs=mega.n_outputs,
            chain=mega.mode == "chain", handoff_rows=m["handoff_rows"])

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

    timing = {"phase": "timing", "batch": CAPACITY, "words": w,
              "reps": args.reps, "nvidia_smi": smi}
    timing["K1"] = {"ms": cuda_ms(k1, args.reps),
                    "plain_ms": cuda_ms(k1_plain, 3, warmup=1),
                    "block_cols": K.cols_per_block(prog.n_unit),
                    **bound(prog.n_gates, [a1[k] for k in (
                        "src_a", "src_b", "dst", "opcode", "step_branch",
                        "output_addrs")], prog.n_inputs, prog.n_outputs)}
    for name, mega in megas.items():
        m = ops.mega_arrays(mega, dev)
        timing[f"K2/{name}"] = {
            "ms": cuda_ms(lambda: mega_call(mega), args.reps),
            "plain_ms": cuda_ms(lambda: ops.mega_forward_words(
                mega, words, use_ref=True), 3, warmup=1),
            "block_cols": K.cols_per_block(mega.n_unit),
            **bound(sum(p.n_gates for p in mega.stages), [m[k] for k in (
                "src_a", "src_b", "dst", "opcode", "step_branch",
                "stage_table", "out_addrs", "out_rows")], mega.n_inputs,
                mega.n_outputs)}
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

    kernels = [
        {"name": "mega_kernel, one stage (K1)", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["logic"], "max_abs_err": max_err["logic"],
         "ms": timing["K1"]["ms"], "plain_ms": timing["K1"]["plain_ms"],
         "bound_ms": timing["K1"]["bound_ms"],
         "bound_by": timing["K1"]["bound_by"], "library_ms": None},
        {"name": "mega_kernel (K2)", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": K2_REPLACES,
         "launches": launches["mega"], "max_abs_err": max_err["mega"],
         "ms": timing["K2/monolithic"]["ms"],
         "plain_ms": timing["K2/monolithic"]["plain_ms"],
         "bound_ms": timing["K2/monolithic"]["bound_ms"],
         "bound_by": timing["K2/monolithic"]["bound_by"],
         "library_ms": None},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def profile_waves(torch, serve_all) -> dict:
    """Trace ``serve_all`` with torch.profiler: wall time, the union of the
    device's busy intervals, its idle share, the mega kernel's device time
    per wave, and device time by kernel name (the five largest).  Busy
    time is None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        waves = len(serve_all())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
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
                      if a.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    kernel_ms = sum(ms for name, ms in by_name if "mega_kernel" in name)
    return {"waves": waves, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if spans else None,
            "device_idle_share": 1 - busy_us / wall_us if spans else None,
            "kernel_device_ms_per_wave": kernel_ms / waves,
            "device_ms_by_name": dict(by_name[:5])}


def artifact_of(engine):
    """The one artifact an engine's cache holds after serving one graph."""
    (key,) = list(engine.cache._entries)
    return engine.cache.peek(key).artifact


if __name__ == "__main__":
    sys.exit(main())
