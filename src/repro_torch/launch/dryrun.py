"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell,
measured on fake tensors.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's jitted step for 256 or 512 forced host devices and reads XLA's
memory and cost analyses.  PyTorch runs eagerly, so here one process
stands for one rank of the production mesh:

  * a ``fake`` process group of 256 ranks (pod1: data 16 x model 16) or
    512 (pod2: pod 2 x data 16 x model 16), whose collectives return at
    once, and the mesh over it (``launch.mesh.make_production_mesh``);
  * the cell's step built under ``FakeTensorMode`` at that rank's shapes,
    so no tensor has storage and any width fits: the sharded train step
    (``train.parallel.ShardedModel`` and ``make_sharded_train_step``, with
    the config's moment dtype and :data:`TRAIN_ACCUM` micro-batches), the
    sharded prefill (the encoder's forward for audio) or the sharded
    decode step on this rank's cache block (``serve.parallel``);
  * the step run once under ``FlopCounterMode`` (its FLOPs: eager mode
    runs every layer and remat's recompute, so the reference's two-depth
    scan correction is not needed), ``launch.roofline.CommCounter`` (the
    collectives' bytes by kind, and the bytes the eager step moves) and
    ``MemTracker`` (the peak of this rank's tensors, started after the
    sharded state exists, counting its parameter and moment blocks, the
    batch and the cache as arguments);
  * ``roofline_from_terms`` on those numbers, on H100 constants.

Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` (or
``--out``), one file a cell, reused unless ``--force``; a failure is
recorded in its file as data.  ``--device`` is the fake tensors' device
(``cuda`` by default, the card the numbers are for; no card is needed,
but a PyTorch built without CUDA takes the CPU, :func:`fake_device`, and
the file says which it was).
Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ShapeCell,
                                          cell_supported, get_config,
                                          input_specs)
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.optim import resolve_moment_dtype
from repro_torch.serve.parallel import ShardedServer
from repro_torch.train.parallel import ShardedModel, batch_rows
from repro_torch.train.trainer import TrainConfig, make_sharded_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# Gradient-accumulation microbatching for the memory giants, as in the
# reference (the standard fit lever at fixed global batch).
TRAIN_ACCUM = {"grok-1-314b": 8, "internvl2-76b": 4}

H100_HBM_BYTES = 80e9     # an H100 SXM's device memory

#: the constants every result names
CONSTANTS = {"device": "NVIDIA H100 SXM", "peak_flops": rf.PEAK_FLOPS,
             "hbm_bw": rf.HBM_BW, "link_bw": rf.LINK_BW,
             "hbm_bytes": H100_HBM_BYTES}


def _mesh_name(multi_pod: bool) -> str:
    return "pod2" if multi_pod else "pod1"


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0,
    for the life of the context.  Its collectives move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry run starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_device(device: str) -> str:
    """The fake tensors' device: ``device``, but the CPU where it names
    CUDA and this PyTorch is built without it (a fake CUDA tensor needs
    the build's CUDA device guard).  The counts do not depend on it: the
    same shapes and dtypes run either way."""
    if torch.device(device).type == "cuda" and \
            not torch.backends.cuda.is_built():
        return "cpu"
    return device


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _inputs(cfg, cell: ShapeCell, rows: slice, device) -> dict:
    """This rank's rows of the cell's inputs (``input_specs``' shapes;
    for a cell outside ``SHAPES``, tokens: the cell's length, one for
    decode), zeros: their values change no count."""
    if cell.name in SHAPES:
        specs = input_specs(cfg, cell.name)
    elif cfg.family in ("audio", "vlm"):
        raise ValueError(f"{cfg.name} ({cfg.family}) takes more than "
                         f"tokens: run it on a cell of SHAPES")
    else:
        s = 1 if cell.kind == "decode" else cell.seq_len
        specs = {"tokens": torch.empty((cell.global_batch, s),
                                       dtype=torch.int32, device="meta")}
    n = len(range(cell.global_batch)[rows])
    return {k: torch.zeros((n, *v.shape[1:]), dtype=v.dtype, device=device)
            for k, v in specs.items()}


def build_step(cfg, cell: ShapeCell, mesh, *, device, train_accum: int = 1,
               seed: int | None = None):
    """(step, arguments, facts): the cell's step on this rank as a
    function of nothing, the tensors it takes as arguments by kind, and
    what the build decided (``tensor_parallel``, ``kv_share``, ``rows``).
    With ``seed`` the model's weights are drawn from it (a real run);
    without, they are left as allocated (fake tensors have no values)."""
    if seed is None:
        model = Transformer(cfg, device)
    else:
        model = init_params(cfg, torch.Generator(device).manual_seed(seed),
                            device)
    # a train step of a purely data-parallel config splits its rows over
    # 'model' too; serving keeps them where the cache's rows are
    rows, axes, n = batch_rows(
        mesh, cell.global_batch,
        include_model=cell.kind == "train" and not cfg.tensor_parallel)

    def facts(tp):
        return {"tensor_parallel": tp is not None,
                "kv_share": tp.kv_share if tp is not None else 0,
                "rows": len(range(cell.global_batch)[rows])}

    if cell.kind == "train":
        model.requires_grad_(True)
        sm = ShardedModel(model, mesh)
        opt = sm.init_opt(resolve_moment_dtype(cfg.moment_dtype))
        batch = _inputs(cfg, cell, rows, device)
        step = make_sharded_train_step(
            cfg, TrainConfig(grad_accum=train_accum), (rows, axes, n))
        args = {"params": [d.to_local() for d in sm.params.values()],
                "moments": [m.to_local() for m in (*opt.mu.values(),
                                                   *opt.nu.values())],
                "batch": list(batch.values()), "cache": []}
        return (lambda: step(sm, opt, batch)), args, facts(sm.tp)
    server = ShardedServer(model, mesh, decode=cell.kind == "decode",
                           context=cell.seq_len)
    params = [d.to_local() for d in server.sm.params.values()]
    if cell.kind == "prefill":
        inputs = _inputs(cfg, cell, rows, device)
        if cfg.is_encoder:
            def step():
                return server.encode(inputs["frames"])
        else:
            def step():
                return server.prefill(inputs["tokens"],
                                      vision=inputs.get("vision"))
        return step, {"params": params, "moments": [],
                      "batch": list(inputs.values()), "cache": []}, \
            facts(server.tp)
    tokens = _inputs(cfg, cell, rows, device)["tokens"]
    cache = server.init_cache(cell.global_batch)
    fields = [v for k, v in cache._asdict().items()
              if isinstance(v, torch.Tensor)]
    return (lambda: server.decode_step(tokens, cache)), \
        {"params": params, "moments": [], "batch": [tokens],
         "cache": fields}, facts(server.tp)


class StepMemTracker(MemTracker):
    """``MemTracker`` over a step that runs the model more than once
    (gradient accumulation's micro-batches): where the model's forward
    starts again, the per-module statistics of the last micro-batch are
    dropped (``reset_mod_stats``) instead of refused.  The peak, which is
    all the dry run reads, runs on across them."""

    def _pre_fw_hook(self, module, inputs) -> None:
        if module in self.memory_tracking and not self._mod_tracker.is_bw \
                and set(self._mod_tracker.parents) - {
                    self._mod_tracker.get_known_fqn(module)} == {"Global"}:
            self.reset_mod_stats()
        super()._pre_fw_hook(module, inputs)


def measure(step, args: dict) -> dict:
    """Run ``step`` once under the FLOP counter, :class:`CommCounter` and
    ``MemTracker`` (its peak counting ``args``' tensors as held before
    the step): FLOPs, bytes moved, collective bytes and counts by kind,
    argument bytes by kind and the peak."""
    mt = StepMemTracker()
    held = [t for ts in args.values() for t in ts]
    mt.track_external(*held)
    flops = FlopCounterMode(display=False)
    comm = rf.CommCounter()
    with flops, comm, mt:
        step()
    peak = sum(s.get("Total", 0) for s in
               mt.get_tracker_snapshot("peak").values())
    arg_bytes = {k: _nbytes(v) for k, v in args.items()}
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(comm.bytes),
            "collectives": dict(comm.collectives),
            "collective_counts": dict(comm.counts),
            "argument_bytes": arg_bytes,
            "peak_bytes": int(peak)}


def measure_cell(cfg, cell: ShapeCell, mesh, *, device="cuda",
                 train_accum: int = 1, fake: bool = True) -> dict:
    """One rank's step of ``cell`` on ``mesh`` (any process group),
    measured (:func:`measure`, and :func:`build_step`'s facts): built and
    run under ``FakeTensorMode`` unless ``fake`` is False (then for
    real, the weights drawn from seed 0)."""
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else \
        contextlib.nullcontext()
    with mode:
        step, args, facts = build_step(cfg, cell, mesh, device=device,
                                       train_accum=train_accum,
                                       seed=None if fake else 0)
        return {**measure(step, args), **facts}


def run_cell(arch: str, shape: str, multi_pod: bool, force: bool = False,
             device: str = "cuda", out_dir: str | os.PathLike | None = None
             ) -> dict:
    """One cell on the production mesh of a fake group of its size, its
    result written to ``out_dir`` (or read from there unless ``force``)."""
    mesh_name = _mesh_name(multi_pod)
    out_dir = Path(out_dir or RESULTS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape}__{mesh_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    ok, reason = cell_supported(cfg, shape)
    result = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "supported": ok, "reason": reason,
              "device": fake_device(device), "constants": CONSTANTS}
    device = result["device"]
    if not ok:
        out_path.write_text(json.dumps(result, indent=1))
        return result

    cell = SHAPES[shape]
    accum = TRAIN_ACCUM.get(arch, 1)
    chips = 512 if multi_pod else 256
    t0 = time.time()
    try:
        with fake_group(chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            m = measure_cell(cfg, cell, mesh, device=device,
                             train_accum=accum)
        mflops = rf.model_flops(cfg, cell)
        terms = rf.roofline_from_terms(
            flops_per_device=m["flops"], bytes_per_device=m["bytes"],
            collective_breakdown=m["collectives"], chips=chips,
            model_flops_total=mflops)
        args = m["argument_bytes"]
        result.update({
            "ok": True, "chips": chips, "seconds": round(time.time() - t0,
                                                         1),
            "train_accum": accum if cell.kind == "train" else None,
            "rows_per_rank": m["rows"],
            "tensor_parallel": m["tensor_parallel"],
            "kv_share": m["kv_share"],
            "flops_per_device": m["flops"],
            "model_flops": mflops,
            "flops_over_model_flops_per_chip": m["flops"] / (mflops / chips),
            "collective_counts": m["collective_counts"],
            "memory": {"argument_bytes": sum(args.values()),
                       "by_kind": args, "peak_bytes": m["peak_bytes"]},
            "fits_h100": m["peak_bytes"] <= H100_HBM_BYTES,
            "roofline": terms.to_dict(),
        })
        print(f"[dryrun] {arch} {shape} {mesh_name}: OK "
              f"{result['seconds']:.0f}s bound={terms.bound} "
              f"(c={terms.compute_s * 1e3:.1f}ms "
              f"m={terms.memory_s * 1e3:.1f}ms "
              f"coll={terms.collective_s * 1e3:.1f}ms) "
              f"flops/(model/chip)="
              f"{result['flops_over_model_flops_per_chip']:.2f} "
              f"peak={m['peak_bytes'] / 1e9:.1f}GB/rank", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures as data
        result.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                       "seconds": round(time.time() - t0, 1),
                       "traceback": traceback.format_exc()[-2000:]})
        print(f"[dryrun] {arch} {shape} {mesh_name}: FAIL {e}",
              flush=True)
    out_path.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (no card is needed)")
    ap.add_argument("--out", default=None,
                    help=f"results directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"pod1": [False], "pod2": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, mp, force=args.force,
                             device=args.device, out_dir=args.out)
                if r.get("supported") and not r.get("ok", False):
                    n_fail += 1
    print(f"[dryrun] done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
