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
    decode step on this rank's cache block (``serve.parallel``), the
    prefill's logits left split by vocabulary as the reference's output
    sharding leaves them;
  * the step run once under ``FlopCounterMode`` (its FLOPs: eager mode
    runs every layer and remat's recompute, so the reference's two-depth
    scan correction is not needed), ``launch.roofline.CommCounter`` (the
    collectives' bytes by kind, and the bytes the eager step moves) and
    ``MemTracker`` (the peak of this rank's tensors, started after the
    sharded state exists, counting its parameter and moment blocks, the
    batch and the cache as arguments: all a rank holds between steps,
    since each weight is gathered inside the step where it is used,
    once a micro-batch in the forward and again in remat's recompute,
    and each gradient reduce-scattered there; and, for the ops of
    :data:`TEMPORARIES`, the temporary their CUDA kernel allocates beside
    its outputs, which a dispatch mode cannot see: ``temp_bytes``);
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
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import (_TOTAL_KEY, MemTracker,
                                                  _MemRefType)
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves
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
        # the logits stay split by vocabulary, the reference's output
        # sharding
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


def _softmax_backward(grad_output, output, dim, input_dtype) -> int:
    """``aten/src/ATen/native/cuda/SoftMax.cu``,
    ``softmax_backward_cuda_out``: ``Tensor tmp = grad * output;`` is
    what ``host_softmax_backward`` reads as the gradient, one tensor of
    the gradient's shape in the product's dtype, live beside the op's
    output until the op returns."""
    dtype = torch.promote_types(grad_output.dtype, output.dtype)
    return grad_output.numel() * dtype.itemsize


class _Allocations(TorchDispatchMode):
    """The bytes of the storages the ops under it allocate (each output
    storage that no tensor before it had)."""

    def __init__(self, held) -> None:
        super().__init__()
        self.seen = {t.untyped_storage()._cdata for t in held}
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self.seen:
                    self.seen.add(st._cdata)
                    self.nbytes += st.nbytes()
        return out


def _einsum(equation, operands, path=None) -> int:
    """``aten/src/ATen/native/Linear.cpp``, ``einsum`` and
    ``sumproduct_pair``: each operand permuted to (batch, kept, summed)
    dims and reshaped to the 3-D ``bmm`` operand, a contiguous copy
    wherever that reshape is not a view, both copies live while ``bmm``
    writes the output.  Where autograd is off (``inference_mode``) the
    op reaches the tracker whole and those copies run inside it: what
    its decomposition allocates beyond the output, counted by running
    it on meta tensors of the operands' sizes and strides."""
    with _disable_current_modes(), torch.inference_mode(False):
        metas = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                     device="meta") for t in operands]
        with _Allocations(metas) as allocs:
            out = torch.ops.aten.einsum.default(equation, metas, path=path)
    return allocs.nbytes - out.untyped_storage().nbytes()


#: The temporaries an op's CUDA kernel allocates inside itself, below the
#: dispatcher, where ``MemTracker`` (a dispatch mode, which sees each op's
#: outputs) cannot see them; on fake tensors they do not exist.  Op
#: overload -> their bytes as a function of the op's arguments, each
#: rule read from the ATen source it cites and held against the card
#: (``tests/test_torch_dryrun_temporaries.py``, ``tools/torch_memtrace.py``).
TEMPORARIES = {
    torch.ops.aten._softmax_backward_data.default: _softmax_backward,
    torch.ops.aten.einsum.default: _einsum,
}


def temporary_bytes(func, args, kwargs) -> int:
    """The bytes ``func``'s CUDA kernel allocates beside its outputs for
    these arguments (:data:`TEMPORARIES`; 0 for any other op)."""
    rule = TEMPORARIES.get(func)
    return 0 if rule is None else int(rule(*args, **kwargs))


class StepMemTracker(MemTracker):
    """``MemTracker`` counting what the card allocates.

    Two changes to its peak: an op of :data:`TEMPORARIES` adds its
    kernel's temporary to the running total of its device for the op's
    duration (the peak taken after the op's outputs exist sees both),
    each op's largest temporary kept by name in ``temp_bytes``, its
    calls in ``temp_calls``, and the temporary live at each device's
    peak summed in :attr:`temp_at_peak`; and over a step that runs the
    model more than once (gradient accumulation's micro-batches), where
    the model's forward starts again, the per-module statistics of the
    last micro-batch are dropped (``reset_mod_stats``) instead of
    refused.  The peak, which is all the dry run reads, runs on across
    them."""

    def __init__(self) -> None:
        super().__init__()
        # the running op's (name, device, temporary), per thread: the
        # backward runs ops on the autograd engine's threads
        self._running = threading.local()
        self._peak_temp: dict[torch.device, int] = {}
        self.temp_bytes: dict[str, int] = {}
        self.temp_calls: dict[str, int] = {}

    @property
    def temp_at_peak(self) -> int:
        return sum(self._peak_temp.values())

    def _pre_fw_hook(self, module, inputs) -> None:
        if module in self.memory_tracking and not self._mod_tracker.is_bw \
                and set(self._mod_tracker.parents) - {
                    self._mod_tracker.get_known_fqn(module)} == {"Global"}:
            self.reset_mod_stats()
        super()._pre_fw_hook(module, inputs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # a DTensor op desugars into local ops, which come back here
        temp = 0 if any(issubclass(t, DTensor) for t in types) else \
            temporary_bytes(func, args, kwargs or {})
        dev = next(t.device for t in tree_leaves(args)
                   if isinstance(t, torch.Tensor)) if temp else None
        self._running.op = (str(func), dev, temp) if temp else None
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._running.op = None

    def _update_peak_stats(self, peak_state) -> None:
        # the tracker calls this once an op's outputs are counted
        before = dict(self._peak_mem)
        op = getattr(self._running, "op", None)
        if op is None:
            super()._update_peak_stats(peak_state)
        else:
            name, dev, temp = op
            self.temp_bytes[name] = max(self.temp_bytes.get(name, 0), temp)
            self.temp_calls[name] = self.temp_calls.get(name, 0) + 1
            snap = self._curr_mem_snap.setdefault(
                dev, dict.fromkeys((*_MemRefType, _TOTAL_KEY), 0))
            snap[_MemRefType.TEMP] += temp
            snap[_TOTAL_KEY] += temp
            try:
                super()._update_peak_stats(peak_state)
            finally:
                snap[_MemRefType.TEMP] -= temp
                snap[_TOTAL_KEY] -= temp
                if snap[_TOTAL_KEY] == 0:
                    del self._curr_mem_snap[dev]
        for d, peak in self._peak_mem.items():
            if peak != before.get(d):
                self._peak_temp[d] = op[2] if op and op[1] == d else 0


def measure(step, args: dict) -> dict:
    """Run ``step`` once under the FLOP counter, :class:`CommCounter` and
    :class:`StepMemTracker` (its peak counting ``args``' tensors as held
    before the step and the kernels' temporaries): FLOPs, bytes moved,
    collective bytes and counts by kind, argument bytes by kind, the
    peak, and the temporaries (each op's largest, its calls, and the one
    live at the peak)."""
    mt = StepMemTracker()
    held = [t for ts in args.values() for t in ts]
    mt.track_external(*held)
    flops = FlopCounterMode(display=False)
    comm = rf.CommCounter()
    with flops, comm, mt:
        step()
    peak = sum(s.get(_TOTAL_KEY, 0) for s in
               mt.get_tracker_snapshot("peak").values())
    arg_bytes = {k: _nbytes(v) for k, v in args.items()}
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(comm.bytes),
            "collectives": dict(comm.collectives),
            "collective_counts": dict(comm.counts),
            "argument_bytes": arg_bytes,
            "peak_bytes": int(peak),
            "temp_bytes": dict(mt.temp_bytes),
            "temp_calls": dict(mt.temp_calls),
            "temp_at_peak": mt.temp_at_peak}


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
                       "by_kind": args, "peak_bytes": m["peak_bytes"],
                       "temp_bytes": m["temp_bytes"],
                       "temp_calls": m["temp_calls"],
                       "temp_at_peak": m["temp_at_peak"]},
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
