"""Which ATen kernels allocate device memory that the dry run's tracker
does not see, on the card (``repro_torch.launch.dryrun``: its
``StepMemTracker`` counts op outputs, and the temporaries of
``TEMPORARIES``).

For each cell, one rank's share of its pod1 step run for real on the
card under the fake 256-rank group (``dryrun.build_step`` with seed 0, as
``chip_smoke.py``'s ``dryrun_share`` runs it):

1. ``dryrun.measure`` on the first step, the card's peak beside it, then
   the card's peak over a plain step;
2. one step under :class:`OpProbe`, a dispatch mode that reads the CUDA
   caching allocator around every op: the peak while the op runs, less
   what was allocated before it and less its new outputs (rounded as the
   allocator rounds), is the op's temporary; what stays allocated after
   it beyond its outputs (a library's workspace) is reported apart.
   Each op overload whose temporary reaches ``--min-mib``, or that has a
   rule, is listed: its calls, its largest temporary with that call's
   arguments, and the largest difference over its calls between the
   temporary and ``dryrun.temporary_bytes``;
3. one more step with the allocator's history recorded (``context`` and
   ``stacks`` "all") around the first call of each op so listed: the C++
   frames of each allocation of that call name the kernel that made it.

Results to ``chiprun_out/memtrace.json``, a summary line a cell on
stdout.  Needs one GPU:

  PYTHONPATH=src python3 tools/torch_memtrace.py [--cells minicpm-2b/train_4k,qwen3-8b/prefill_32k,qwen3-8b/decode_32k] [--min-mib 16]
"""
from __future__ import annotations

import argparse
import gc
import inspect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("minicpm-2b/train_4k", "qwen3-8b/prefill_32k",
         "qwen3-8b/decode_32k")
# allocator internals and the unwinder: not the kernel that asked
_SKIP_FRAMES = ("CachingAllocator", "CapturedTraceback", "unwind",
                "c10::cuda::", "gather_with_cpp", "torch::CapturedTraceback")


def _round(nbytes: int) -> int:
    """A block's bytes as the caching allocator counts them (512-byte
    multiples)."""
    return -(-nbytes // 512) * 512


def _describe(x):
    import torch
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype),
                "stride": list(x.stride())}
    if isinstance(x, (list, tuple)):
        return [_describe(v) for v in x]
    return repr(x)


def _frames(frames: list) -> dict:
    py = [f"{f['filename'].split('src/')[-1]}:{f['line']}:{f['name']}"
          for f in frames if f["filename"].endswith(".py") and
          "repro_torch" in f["filename"]][:4]
    cpp = [f["name"] for f in frames if not f["filename"].endswith(".py")
           and not any(s in f["name"] for s in _SKIP_FRAMES)][:14]
    return {"cpp": cpp, "python": py}


def make_probe(torch, dev, *, trace=(), min_bytes=0):
    """A dispatch mode measuring each op's temporary on ``dev`` (see the
    module's docstring); with ``trace``, the allocator's history around
    the first call of each op named there."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch import dryrun

    clear = "clear_history" in inspect.signature(
        torch.cuda.memory._record_memory_history).parameters

    class OpProbe(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}
            self.traces = {}
            self.peak = 0

        def _ptrs(self, tree) -> dict:
            out = {}
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor) and t.device == dev:
                    st = t.untyped_storage()
                    try:
                        out[st.data_ptr()] = st.nbytes()
                    except RuntimeError:    # a storage without data
                        pass
            return out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            name = str(func)
            ins = self._ptrs((args, kwargs))
            record = name in trace and name not in self.traces
            if record:
                kw = {"clear_history": True} if clear else {}
                torch.cuda.memory._record_memory_history(
                    enabled="all", context="all", stacks="all", **kw)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = func(*args, **kwargs)
            peak = torch.cuda.max_memory_allocated(dev)
            after = torch.cuda.memory_allocated(dev)
            if record:
                snap = torch.cuda.memory._snapshot()
                torch.cuda.memory._record_memory_history(enabled=None)
                evs = snap["device_traces"][dev.index or 0]
                self.traces[name] = [
                    {"size": e["size"], **_frames(e.get("frames") or [])}
                    for e in evs if e["action"] == "alloc" and
                    e["size"] >= 2**20]
            new = sum(_round(n) for p, n in self._ptrs(out).items()
                      if p not in ins and n > 0)
            self.peak = max(self.peak, peak)
            temp = peak - before - new
            rule = dryrun.temporary_bytes(func, args, kwargs)
            op = self.ops.setdefault(name, {
                "calls": 0, "temp_max": 0, "temp_calls": 0,
                "persistent": 0, "rule_max": 0, "max_abs_diff": 0})
            op["calls"] += 1
            op["persistent"] += max(0, after - before - new)
            op["rule_max"] = max(op["rule_max"], rule)
            op["max_abs_diff"] = max(op["max_abs_diff"], abs(temp - rule))
            if temp >= min_bytes and min_bytes:
                op["temp_calls"] += 1
            if temp > op["temp_max"]:
                op.update(temp_max=temp, rule_at_max=rule,
                          args_at_max=_describe(list(args)))
            return out

    return OpProbe()


def run_cell(torch, dev, arch: str, shape: str, min_bytes: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg, cell = get_config(arch), SHAPES[shape]
    committed = dryrun.RESULTS_DIR / f"{arch}__{shape}__pod1.json"
    predicted = json.loads(committed.read_text())["memory"]
    gc.collect()        # an earlier cell's cycles, not freed mid-step
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    out = {"cell": f"{arch}/{shape}/pod1"}
    t0 = time.perf_counter()
    with dryrun.fake_group(256):
        mesh = make_production_mesh(multi_pod=False, device=dev.type)
        step, args, facts = dryrun.build_step(
            cfg, cell, mesh, device=dev, seed=0,
            train_accum=dryrun.TRAIN_ACCUM.get(arch, 1))
        torch.cuda.synchronize(dev)
        out["build_s"] = time.perf_counter() - t0
        out["held_bytes"] = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        m = dryrun.measure(step, args)
        torch.cuda.synchronize(dev)
        out["card_peak_first"] = torch.cuda.max_memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        step()
        torch.cuda.synchronize(dev)
        out["card_peak"] = torch.cuda.max_memory_allocated(dev) - base
        out.update({k: m[k] for k in ("flops", "peak_bytes", "temp_bytes",
                                      "temp_calls", "temp_at_peak")})
        out["argument_bytes"] = sum(m["argument_bytes"].values())
        out["committed"] = predicted
        out["ratio_to_tracked"] = out["card_peak_first"] / m["peak_bytes"]
        t0 = time.perf_counter()
        probe = make_probe(torch, dev, min_bytes=min_bytes)
        with probe:
            step()
        torch.cuda.synchronize(dev)
        out["probe_s"] = time.perf_counter() - t0
        out["probe_peak"] = probe.peak - base
        ops = {k: v for k, v in probe.ops.items()
               if v["temp_max"] >= min_bytes or v["rule_max"] or
               v["max_abs_diff"] >= min_bytes}
        out["ops"] = dict(sorted(ops.items(),
                                 key=lambda kv: -kv[1]["temp_max"]))
        out["persistent"] = {k: v["persistent"] for k, v in
                             probe.ops.items() if v["persistent"]}
        t0 = time.perf_counter()
        tracer = make_probe(torch, dev, trace=set(ops))
        with tracer:
            step()
        torch.cuda.synchronize(dev)
        out["trace_s"] = time.perf_counter() - t0
        out["frames"] = tracer.traces
        del step, args
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--min-mib", type=float, default=16)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "memtrace.json"))
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_memtrace.py reads the CUDA allocator: it needs a GPU",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    res = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cells": []}
    for name in a.cells.split(","):
        arch, shape = name.split("/")
        r = run_cell(torch, dev, arch, shape, int(a.min_mib * 2**20))
        res["cells"].append(r)
        print(json.dumps({k: r[k] for k in (
            "cell", "held_bytes", "argument_bytes", "peak_bytes",
            "temp_at_peak", "card_peak_first", "card_peak",
            "ratio_to_tracked", "probe_peak", "probe_s", "trace_s")}),
            flush=True)
        print(json.dumps({k: {f: v[f] for f in ("calls", "temp_max",
                                                "rule_max", "max_abs_diff")}
                          for k, v in r["ops"].items()}), flush=True)
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
