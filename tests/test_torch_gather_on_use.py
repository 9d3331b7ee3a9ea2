"""Gather on use in the sharded train step (``train/parallel.py``), on gloo
ranks and a fake group on the CPU.

The reference scans its layers over layer-stacked weights with FSDP
shardings, so XLA gathers each layer's weights inside the scan body and
each micro-batch's gradient leaves by a reduce-scatter into the
parameter's sharding.  The port's step reads each weight through
``ShardedModel.weight`` when the model uses it and differentiates the
storage blocks themselves, its float32 accumulators in their shapes.
Held here:

  (a) the step with ``grad_accum`` 2 and remat "full" (every large
      config's: the gathers run again in the backward's recompute) on
      (data 2, model 1), (data 2, model 2) and (pod 2, data 1, model 1)
      against one process, within ``test_torch_sharded_train.py``'s
      tolerances (loss and grad norm within rtol 1e-5, parameters within
      4 lr, at most 1 in 10,000 elements past 1e-5): dense (qwen3-8b),
      moe (mixtral-8x7b), hybrid (recurrentgemma-2b at 5 layers, its
      embedding tied) and minicpm-2b's tied embedding, gathered twice a
      micro-batch (the lookup and the head) with its gradient the sum of
      both uses;
  (b) on a (1, 1) mesh nothing moves, and two steps equal one device's
      bit for bit (loss, grad norm, every parameter and moment);
  (c) what a rank keeps: the module holds no parameter, no gathered
      tensor outlives its use, and the floating-point tensors alive in
      the rank (made since before the model was built) are exactly its
      storage blocks and moments between steps, and those plus the
      storage-shaped float32 accumulators when the micro-batches end;
  (d) the dry run of one small config on a fake 16-rank group (data 16)
      under remat "full" with 2 micro-batches: its all-gathers are every
      block's gathered weights twice a micro-batch (the forward and the
      recompute) and the top-level ones (outside the checkpointed blocks,
      as outside the reference's scan) once, a reduce-scatter a gathered
      leaf a micro-batch, and its peak below the peak of gathering up
      front, which holds at least the arguments, every weight gathered
      and float32 accumulators of the gathered shapes.

Each run starts its ranks as subprocesses on a free port, with a timeout,
so a fault cannot hang the suite.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import free_port
from repro_torch.train import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, STEPS, ACCUM = 8, 16, 2, 2
TIMEOUT = 300
LR = 1e-3
P_ATOL = 1e-5
OUTLIERS = 1e-4

#: case -> (arch, config overrides)
ARCHS = {"dense": ("qwen3-8b", {}), "moe": ("mixtral-8x7b", {}),
         "hybrid": ("recurrentgemma-2b", {"n_layers": 5}),
         "tied": ("minicpm-2b", {})}
#: mesh -> (shape, dim names)
MESHES = {"2x1": ((2, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "pod2x1x1": ((2, 1, 1), ("pod", "data", "model"))}

WORKER = r"""
import gc, json, os, sys, weakref, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import destroy, init_distributed
from repro_torch.train import TrainConfig, Trainer

job = json.loads(sys.argv[1])
init_distributed("cpu")
rank = torch.distributed.get_rank()


def trainer(arch, over, mesh, ckpt, remat, compress=False):
    cfg = get_config(arch, smoke=True).with_(remat=remat, **over)
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                     grad_accum=job["accum"], compress_grads=compress,
                     checkpoint_dir=ckpt, checkpoint_every=1000)
    return Trainer(cfg, tc, "cpu", job["batch"], job["seq"], mesh=mesh)


def mesh_of(shape, names):
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def live_floats():
    # every floating-point tensor of one dim or more alive in the process,
    # by storage (0-d ones, the loss and metrics, aside)
    gc.collect()
    out = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and not isinstance(o, DTensor) \
                and o.is_floating_point() and o.dim() >= 1:
            st = o.untyped_storage()
            out[st.data_ptr()] = (st.nbytes(), o)
    return out


def held(arch, over, mesh, ckpt):
    # (c): what the rank keeps between steps and when the micro-batches end
    before = live_floats()      # kept alive, so no address is reused
    t = trainer(arch, over, mesh, ckpt, "full")
    sm, opt = t.init_state()
    gathered, at_reduce = [], []
    gather, reduce = sm.gather, sm.reduce

    def gather_seen(name, local):
        out = gather(name, local)
        gathered.append(weakref.ref(out))
        return out

    def reduce_seen(loss, grads, n):
        at_reduce.append(sum(b for p, (b, _) in live_floats().items()
                             if p not in before))
        return reduce(loss, grads, n)

    sm.gather, sm.reduce = gather_seen, reduce_seen
    between = []
    for i in range(job["steps"]):
        sm, opt, _ = t.train_step(sm, opt, t.batch(i))
        between.append(sum(b for p, (b, _) in live_floats().items()
                           if p not in before))
    storage = sum(x.numel() * x.element_size() for x in sm.leaves.values())
    moments = sum(m.to_local().numel() * m.to_local().element_size()
                  for m in (*opt.mu.values(), *opt.nu.values()))
    return {"storage": storage, "moments": moments,
            "accumulators": 4 * sum(x.numel() for x in sm.leaves.values()),
            "between": between, "at_reduce": at_reduce,
            "module_params": len(list(sm.module.parameters())),
            "gathered": len(gathered),
            "gathered_alive": sum(r() is not None for r in gathered)}


def run(arch, over, mesh, ckpt, remat, compress=False):
    t = trainer(arch, over, mesh, ckpt, remat, compress)
    hist = [{k: h[k] for k in ("loss", "grad_norm", "lr")}
            for h in t.run(job["steps"], log_every=0)]
    return t, hist


out = {}
if job["kind"] == "match":          # (a) and (c)
    for name, shape, names in job["meshes"]:
        mesh = mesh_of(shape, names)
        for case, (arch, over) in job["archs"].items():
            t, hist = run(arch, over, mesh,
                          os.path.join(job["dir"], name + case), "full")
            out[name, case] = {"history": hist,
                               "params": t.model.full_state_dict(),
                               "tp": t.model.tp is not None}
        out[name, "held"] = held("qwen3-8b", {}, mesh,
                                 os.path.join(job["dir"], name + "held"))
else:                               # (b): one rank, against one device
    mesh = mesh_of((1, 1), ("data", "model"))
    for case, (arch, over) in job["archs"].items():
        for compress in (False, True):
            key = f"{case}-{compress}"
            t, hist = run(arch, over, mesh,
                          os.path.join(job["dir"], key + "m"), "none",
                          compress)
            one, hist1 = run(arch, over, None,
                             os.path.join(job["dir"], key + "o"), "none",
                             compress)
            mine = dict(one.model.named_parameters())
            out[key] = {
                "metrics_equal": hist == hist1,
                "params_equal": all(
                    torch.equal(x, mine[n].detach())
                    for n, x in t.model.leaves.items()),
                "moments_equal": all(
                    torch.equal(t.opt.mu[n].to_local(), one.opt.mu[n])
                    and torch.equal(t.opt.nu[n].to_local(), one.opt.nu[n])
                    for n in mine),
                "moved": any(t.model.weight(n) is not x
                             for n, x in t.model.leaves.items())}
if rank == 0:
    torch.save(out, job["out"])
destroy()
"""

FAKE_WORKER = r"""
import json, sys, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.models.transformer import Transformer
from repro_torch.train.sharding import param_placements

job = json.loads(sys.argv[1])
cfg = get_config(job["arch"], smoke=True).with_(**job["over"])
with dryrun.fake_group(job["world"]):
    mesh = init_device_mesh("cpu", (job["world"], 1),
                            mesh_dim_names=("data", "model"))
    m = dryrun.measure_cell(cfg, ShapeCell("t", "train", job["seq"],
                                           job["batch"]),
                            mesh, device="cpu", train_accum=job["accum"])
    pl = param_placements(cfg, mesh)
    leaves = {n: (p.numel() * p.element_size(), p.numel())
              for n, p in Transformer(cfg, "cpu").named_parameters()}
print(json.dumps({
    "measured": {k: m[k] for k in ("collectives", "collective_counts",
                                   "argument_bytes", "peak_bytes")},
    "tensor_parallel": m["tensor_parallel"],
    "leaves": {n: {"bytes": b, "numel": k,
                   "gathered": pl[n][0].is_shard()}
               for n, (b, k) in leaves.items()}}))
"""


def _run_ranks(job: dict, world: int, tmp: Path) -> dict:
    """Start ``world`` gloo ranks of WORKER on a free port; rank 0's
    results."""
    job = dict(dict(batch=BATCH, seq=SEQ, steps=STEPS, accum=ACCUM), **job,
               out=str(tmp / "out.pt"), dir=str(tmp / "ck"))
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps(job)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return torch.load(tmp / "out.pt", weights_only=False)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(mesh, case) -> a sharded run: one group of ranks per world size
    runs every case on its meshes."""
    out = {}
    for world, meshes in ((2, ["2x1", "pod2x1x1"]), (4, ["2x2"])):
        out.update(_run_ranks(
            {"kind": "match", "archs": ARCHS,
             "meshes": [(m, *MESHES[m]) for m in meshes]}, world,
            tmp_path_factory.mktemp(f"world{world}")))
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    cache = {}

    def get(case):
        if case not in cache:
            arch, over = ARCHS[case]
            cfg = get_config(arch, smoke=True).with_(remat="full", **over)
            tc = TrainConfig(lr=LR, warmup_steps=1, total_steps=10,
                             grad_accum=ACCUM, checkpoint_every=1000,
                             checkpoint_dir=str(tmp_path_factory.mktemp(
                                 "one")))
            t = Trainer(cfg, tc, "cpu", BATCH, SEQ)
            hist = t.run(STEPS, log_every=0)
            cache[case] = (hist, {n: p.detach().clone() for n, p in
                                  t.model.named_parameters()})
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(ARCHS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gathered_step_matches_one_process(mesh, case, sharded, one_process):
    got = sharded[mesh, case]
    hist, params = one_process(case)
    assert len(got["history"]) == len(hist) == STEPS
    for g, w in zip(got["history"], hist):
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert set(got["params"]) == set(params)
    outside = total = 0
    for n, p in params.items():
        diff = (got["params"][n] - p).abs()
        assert float(diff.max()) <= 4 * LR, n
        outside += int((diff > P_ATOL).sum())
        total += p.numel()
    assert outside <= OUTLIERS * total, (outside, total)
    assert got["tp"] == mesh.startswith("2x2")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_keeps_storage_moments_and_accumulators(mesh, sharded):
    h = sharded[mesh, "held"]
    assert h["module_params"] == 0
    # 'data' splits the weights, so they gather; 'pod' stores them whole
    assert (h["gathered"] > 0) == (mesh != "pod2x1x1")
    assert h["gathered_alive"] == 0
    assert h["between"] == [h["storage"] + h["moments"]] * STEPS
    assert h["at_reduce"] == [h["storage"] + h["moments"] +
                              h["accumulators"]] * STEPS


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _run_ranks({"kind": "one", "archs": {
        k: ARCHS[k] for k in ("dense", "moe", "tied")}}, 1,
        tmp_path_factory.mktemp("one_rank"))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("case", ["dense", "moe", "tied"])
def test_one_by_one_mesh_is_bit_equal_to_one_device(case, compress,
                                                    one_rank):
    got = one_rank[f"{case}-{compress}"]
    assert not got["moved"]
    assert got["metrics_equal"]
    assert got["params_equal"]
    assert got["moments_equal"]


FAKE = dict(arch="qwen3-8b", over={"remat": "full", "n_layers": 4},
            world=16, batch=32, seq=16, accum=2)


@pytest.fixture(scope="module")
def fake_cell():
    res = subprocess.run(
        [sys.executable, "-c", FAKE_WORKER, json.dumps(FAKE)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_dryrun_gathers_each_layer_twice_a_micro_batch(fake_cell):
    """Every block leaf sharded over 'data' is gathered in the forward and
    again in the recompute of each micro-batch; the embedding and head,
    outside the checkpointed blocks, once; each gathered leaf's gradient
    leaves by one reduce-scatter a micro-batch."""
    mb = FAKE["accum"]
    leaves = fake_cell["leaves"]
    gathered = {n: v for n, v in leaves.items() if v["gathered"]}
    blocks = sum(v["bytes"] for n, v in gathered.items()
                 if n.startswith("blocks."))
    top = sum(v["bytes"] for n, v in gathered.items()
              if not n.startswith("blocks."))
    assert blocks > 0 and top > 0
    m = fake_cell["measured"]
    assert not fake_cell["tensor_parallel"]
    assert m["collectives"]["all-gather"] == mb * (2 * blocks + top)
    n_blocks = sum(n.startswith("blocks.") for n in gathered)
    assert m["collective_counts"]["all-gather"] == \
        mb * (2 * n_blocks + len(gathered) - n_blocks)
    assert m["collective_counts"]["reduce-scatter"] == mb * len(gathered)


def test_dryrun_peak_below_gathering_up_front(fake_cell):
    """Gathering up front holds, besides the arguments, every weight
    gathered and float32 accumulators of the gathered shapes for the
    whole step: the peak of gathering on use stays below that."""
    m = fake_cell["measured"]
    leaves = fake_cell["leaves"].values()
    args = sum(m["argument_bytes"].values())
    up_front = args + sum(v["bytes"] for v in leaves) + \
        4 * sum(v["numel"] for v in leaves)
    assert m["peak_bytes"] < up_front
    # and within the arguments, float32 accumulators of the storage
    # blocks and a few layers' gathered weights and gradients
    stored = m["argument_bytes"]["params"]
    assert m["peak_bytes"] < args + 2 * stored + \
        0.5 * sum(v["bytes"] for v in leaves)
