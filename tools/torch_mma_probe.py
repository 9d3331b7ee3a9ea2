#!/usr/bin/env python3
"""Time one tensor-core instruction at a time on one CUDA GPU (Hopper).

Run from the root of a checkout:  ``python3 tools/torch_mma_probe.py``

Builds ``tools/torch_mma_probe.cu`` once per variant with nvcc for
``sm_90a`` (a variant that ptxas refuses is reported as refused), counts the
tensor-core instructions in each build's SASS (``cuobjdump --dump-sass``),
and times a loop of that one instruction on every SM: the rate that K3's
design choice (b1 ``mma`` with AND-popc, or int8 ``mma`` on expanded bits)
rests on.  Operations are counted as the int8 tensor-core peak counts them,
2 per multiply-add: 2*16*8*256 per b1 m16n8k256 and 2*16*8*32 per int8
m16n8k32.  Prints one JSON line per variant, then the card's name and power
limit as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "torch_mma_probe.cu"
VARIANTS = {  # PROBE_VARIANT -> (instruction, operations per instruction)
    0: ("mma.m16n8k256.b1.and.popc", 2 * 16 * 8 * 256),
    1: ("mma.m16n8k256.b1.xor.popc", 2 * 16 * 8 * 256),
    2: ("mma.m16n8k32.s8", 2 * 16 * 8 * 32),
    3: ("mma.m16n8k32.u8", 2 * 16 * 8 * 32),
}
TC_OPCODES = re.compile(r"\b(BMMA|IMMA|HMMA|HGMMA|IGMMA|BGMMA)\b[\w.]*")


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--blocks-per-sm", type=int, default=4)
    ap.add_argument("--threads", type=int, default=256)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 3
    from torch.utils.cpp_extension import CUDA_HOME
    cuda_bin = Path(CUDA_HOME) / "bin"
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    smi = nvidia_smi("name,power.limit")
    out_dir = Path(tempfile.mkdtemp(prefix="mma_probe_"))
    procs = {}
    for v in VARIANTS:
        lib = out_dir / f"probe_{v}.so"
        procs[v] = (lib, subprocess.Popen(
            [str(cuda_bin / "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             f"-DPROBE_VARIANT={v}", "-o", str(lib), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    blocks = props.multi_processor_count * args.blocks_per_sm
    warps = blocks * args.threads // 32
    for v, (name, ops_per) in VARIANTS.items():
        lib_path, proc = procs[v]
        log = proc.communicate()[0]
        row = {"variant": name, "built": proc.returncode == 0}
        if proc.returncode != 0:
            row["nvcc"] = log.strip().splitlines()[-3:]
            print(json.dumps(row), flush=True)
            continue
        sass = subprocess.run([str(cuda_bin / "cuobjdump"), "--dump-sass",
                               str(lib_path)], capture_output=True,
                              text=True).stdout
        found = TC_OPCODES.findall(sass)
        row["sass_tensor_ops"] = len(found)
        row["sass_opcodes"] = sorted({m.group(0) for m in
                                      TC_OPCODES.finditer(sass)})
        lib = ctypes.CDLL(str(lib_path))
        lib.probe_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.probe_launch.restype = ctypes.c_int
        chains = lib.probe_chains()
        out = torch.empty(blocks * args.threads, dtype=torch.int32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(iters):
            err = lib.probe_launch(out.data_ptr(), blocks, args.threads,
                                   iters, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        launch(16)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(args.iters)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        sec = min(times)
        n_mma = warps * args.iters * chains
        row.update(seconds=sec, mma=n_mma, ops_per_mma=ops_per,
                   ops_per_s=n_mma * ops_per / sec,
                   mma_per_sm_per_clock=n_mma / sec / clock_hz
                   / props.multi_processor_count,
                   blocks=blocks, threads=args.threads, iters=args.iters)
        print(json.dumps(row), flush=True)
    print(json.dumps({"sms": props.multi_processor_count,
                      "max_sm_clock_hz": clock_hz,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
