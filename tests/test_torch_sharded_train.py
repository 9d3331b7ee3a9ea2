"""The sharded trainer (``Trainer(..., mesh=)``) on gloo ranks on the CPU,
held against the one-process ``Trainer`` (itself held against the
reference's jitted step by ``test_torch_train_step.py``), since the
reference's own sharded trainer fails on the CPU (its ``test_train.py``).

qwen3-8b smoke in float32 on five meshes: (data 2, model 1), (1, 2),
(2, 2), (1, 4) and (pod 2, data 2, model 1), the (1, 2), (2, 2) and
(1, 4) ones running the model tensor parallel over 'model' (on (1, 4)
its 2 kv heads fewer than the 4 ranks: each head shared by 2, its
columns gathered and its gradient summed in their group); each with
``grad_accum`` 1 and 2 and the int8 round trip off and on.  After two steps the loss and the
gradient norm of each step agree within rtol 1e-5, and the gathered
parameters within atol 1e-5.  Adam moves an element by about lr = 1e-3
whatever its gradient's size, so where a gradient cancels to near zero
the summation order of the split products and of the all-reduce turns
float32 noise into a visible share of lr (with the int8 round trip, an
element whose noise straddles a rounding midpoint moves a whole int8
level): at most OUTLIERS of the elements (1 in 10,000) may fall outside
1e-5, each still within the update's own size, 4 lr.
On (1, 2) also minicpm-2b smoke (MHA, the tied embedding's vocabulary
split shared by the lookup and the head) and qwen3-8b smoke with remat
"full" (a block recomputed with its collectives).  Every rank's
parameters and moments carry the reference's specs as placements.  A
checkpoint written under (2, 1) restores under (1, 2), and in one
process, bit for bit; the launcher trains under a two-rank group and
refuses a ``--model-parallel`` that does not divide it.

The other families on (2, 1), (1, 2) and (2, 2), with ``grad_accum`` 1
and the round trip off, and 2 with it on, at the same tolerances:
mixtral-8x7b smoke tensor parallel on each expert's F (its router's
gradient summed over 'model'), mamba2-370m purely data parallel (its
rows split over 'model' too) and recurrentgemma-2b at 5 layers (one
group and a 2-layer tail) gathered over 'model'; their
placements (the MoE's ``_MOE_3D``, the hybrid's ``groups`` and ``tail``)
the reference's, and a hybrid checkpoint restored across meshes bit for
bit.  internvl2-76b (tensor parallel, its patch embeddings before the
split lookup) and hubert-xlarge (gathered) through
``make_sharded_train_step`` on explicit batches, against the one-device
step.

Each run starts its own ranks as subprocesses on a free port, with a
timeout, so a fault cannot hang the suite.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.transformer import param_shapes as ref_param_shapes
from repro.train import sharding as ref_shd
from repro_torch.configs import get_config
from repro_torch.convert import reference_layout
from repro_torch.launch.mesh import free_port
from repro_torch.models.transformer import hybrid_grouping
from repro_torch.train import CheckpointManager, TrainConfig, Trainer
from repro_torch.train import sharding as shd

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-8b"
BATCH, SEQ, STEPS = 8, 16, 2
MESHES = {"2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "pod2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
VARIANTS = [(1, False), (2, False), (1, True), (2, True)]
TIMEOUT = 180
P_ATOL = 1e-5
OUTLIERS = 1e-4
LR = 1e-3

WORKER = r"""
import json, os, sys, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import destroy, init_distributed
from repro_torch.train import TrainConfig, Trainer

job = json.loads(sys.argv[1])
init_distributed("cpu")
rank = torch.distributed.get_rank()
cfg = get_config(job["arch"], smoke=True).with_(remat=job["remat"],
                                                **job["over"])


def code(pl):
    return [p.dim if p.is_shard() else -1 for p in pl]


def trainer(mesh, ckpt, accum=1, compress=False):
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                     grad_accum=accum, compress_grads=compress,
                     checkpoint_dir=ckpt, checkpoint_every=1000)
    return Trainer(cfg, tc, "cpu", job["batch"], job["seq"], mesh=mesh)


def mesh_of(shape, names):
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def steps(mesh, variants, sub=""):
    res = {}
    for accum, compress in variants:
        t = trainer(mesh, os.path.join(job["dir"], f"{sub}{accum}{compress}"),
                    accum, compress)
        hist = t.run(job["steps"], log_every=0)
        full = t.model.full_state_dict()
        res[f"{accum}-{compress}"] = {
            "history": [{k: h[k] for k in ("loss", "grad_norm", "lr")}
                        for h in hist],
            "params": full,
            "placements": {n: code(d.placements)
                           for n, d in t.model.params.items()},
            "moments": {n: code(d.placements)
                        for n, d in t.opt.mu.items()},
            "tp": t.model.tp is not None,
            "kv_share": t.model.tp.kv_share if t.model.tp else 0,
            "rows": [t.rows[0].start, t.rows[0].stop],
        }
    return res


out = {}
if job["kind"] == "step":
    out = steps(mesh_of(job["shape"], job["names"]), job["variants"])
elif job["kind"] == "families":         # each arch on each mesh
    for arch, over in job["archs"]:
        cfg = get_config(arch, smoke=True).with_(**over)
        for shape in job["shapes"]:
            key = "x".join(map(str, shape))
            out[arch, key] = steps(mesh_of(shape, ("data", "model")),
                                   job["variants"], f"{arch}{key}")
elif job["kind"] == "explicit":         # make_sharded_train_step
    from repro_torch.models.pspec_utils import activation_sharding
    from repro_torch.models.transformer import init_params
    from repro_torch.train.parallel import ShardedModel, batch_rows
    from repro_torch.train.trainer import make_sharded_train_step
    mesh = mesh_of(job["shape"], job["names"])
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sm = ShardedModel(model.requires_grad_(True), mesh)
    opt = sm.init_opt(torch.float32)
    rows = batch_rows(mesh, job["batch"],
                      include_model=not cfg.tensor_parallel)
    step = make_sharded_train_step(cfg, TrainConfig(
        lr=1e-3, warmup_steps=1, total_steps=10), rows)
    hist = []
    with activation_sharding(mesh):
        for b in torch.load(job["batches"]):
            sm, opt, m = step(sm, opt, {k: v[rows[0]] for k, v in b.items()})
            hist.append({k: float(v) for k, v in m.items()})
    out = {"history": hist, "params": sm.full_state_dict(),
           "tp": sm.tp is not None}
else:                                   # checkpoint across meshes
    a = trainer(mesh_of((2, 1), ("data", "model")), job["dir"])
    a.run(job["steps"], log_every=0)
    saved = (a.model.full_state_dict(),
             {n: d.full_tensor() for n, d in a.opt.mu.items()})
    b = trainer(mesh_of((1, 2), ("data", "model")), job["dir"])
    b.run(0)
    out = {"saved": saved,
           "restored": (b.model.full_state_dict(),
                        {n: d.full_tensor() for n, d in b.opt.mu.items()}),
           "step": b.step,
           "placements": {n: code(d.placements)
                          for n, d in b.model.params.items()}}
if rank == 0:
    torch.save(out, job["out"])
destroy()
"""


def _run_ranks(job: dict, world: int, tmp: Path) -> dict:
    """Start ``world`` gloo ranks of WORKER on a free port; rank 0's
    results."""
    job = dict(dict(arch=ARCH, remat="none", over={}, batch=BATCH, seq=SEQ,
                    steps=STEPS), **job, out=str(tmp / "out.pt"),
               dir=str(tmp / "ck"))
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
def sharded_runs(tmp_path_factory):
    cache = {}

    def get(mesh):
        if mesh not in cache:
            shape, names = MESHES[mesh]
            cache[mesh] = _run_ranks(
                {"kind": "step", "shape": shape, "names": names,
                 "variants": VARIANTS}, int(np.prod(shape)),
                tmp_path_factory.mktemp(mesh))
        return cache[mesh]
    return get


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    cache = {}

    def get(accum, compress):
        if (accum, compress) not in cache:
            tc = TrainConfig(
                lr=1e-3, warmup_steps=1, total_steps=10, grad_accum=accum,
                compress_grads=compress, checkpoint_every=1000,
                checkpoint_dir=str(tmp_path_factory.mktemp("one")))
            t = Trainer(get_config(ARCH, smoke=True), tc, "cpu", BATCH, SEQ)
            hist = t.run(STEPS, log_every=0)
            cache[accum, compress] = (hist, {
                n: p.detach().clone() for n, p in
                t.model.named_parameters()})
        return cache[accum, compress]
    return get


def _assert_matches(got: dict, hist: list, params: dict) -> None:
    """A sharded run against one process's: each step's loss and grad
    norm within rtol 1e-5 (lr 1e-6), the parameters within 4 lr and at
    most OUTLIERS of them past P_ATOL."""
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


@pytest.mark.parametrize("accum,compress", VARIANTS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_step_matches_one_process(mesh, accum, compress,
                                          sharded_runs, one_process):
    got = sharded_runs(mesh)[f"{accum}-{compress}"]
    _assert_matches(got, *one_process(accum, compress))
    # the model ran tensor parallel exactly where 'model' has more than
    # one rank; on (1, 4) its 2 kv heads are each shared by 2 ranks
    model = MESHES[mesh][0][-1]
    assert got["tp"] == (model > 1)
    assert got["kv_share"] == (2 if model == 4 else 1 if model > 1 else 0)


@pytest.mark.parametrize("arch,remat", [("minicpm-2b", "none"),
                                         ("qwen3-8b", "full")])
def test_tied_embeddings_and_remat_under_tensor_parallel(arch, remat,
                                                        tmp_path):
    """minicpm's tied embedding (the vocabulary split shared by the lookup
    and the head, MHA) and a block recomputed with its collectives (remat
    "full"), on (1, 2) with 2 micro-batches, against one process."""
    cfg = get_config(arch, smoke=True).with_(remat=remat)
    tc = TrainConfig(lr=LR, warmup_steps=1, total_steps=10, grad_accum=2,
                     checkpoint_every=1000,
                     checkpoint_dir=str(tmp_path / "one"))
    one = Trainer(cfg, tc, "cpu", BATCH, SEQ)
    hist = one.run(STEPS, log_every=0)
    got = _run_ranks({"kind": "step", "shape": (1, 2),
                      "names": ("data", "model"), "variants": [(2, False)],
                      "arch": arch, "remat": remat}, 2, tmp_path)["2-False"]
    assert got["tp"]
    for g, w in zip(got["history"], hist):
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    outside = total = 0
    for n, p in one.model.named_parameters():
        diff = (got["params"][n] - p.detach()).abs()
        assert float(diff.max()) <= 4 * LR, n
        outside += int((diff > P_ATOL).sum())
        total += p.numel()
    assert outside <= OUTLIERS * total, (outside, total)


def _codes(spec, names) -> list:
    """A spec's placements as tensor dims (-1 replicated), mesh dim by
    mesh dim."""
    out = []
    for a in names:
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(dims[0] if dims else -1)
    return out


class FakeMesh:
    def __init__(self, shape: dict):
        self._shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


def _assert_reference_placements(got: dict, arch: str, over: dict,
                                 shape, names) -> None:
    """Parameters: the reference's spec of the leaf that holds the layer
    (a ``blocks`` or ``groups`` stack's spec without its layer axis, a
    ``tail`` layer's own); moments: the reference's moment rule on the
    per-layer tree (ZeRO over 'pod' on a 3-axis mesh)."""
    fake = FakeMesh(dict(zip(names, shape)))
    ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), **over)
    cfg = get_config(arch, smoke=True).with_(**over)
    stacked = ref_shd.param_pspecs(ref_cfg, fake, ref_param_shapes(ref_cfg))
    layers = shd.param_shapes(cfg, "layers")
    ref_layers = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                  for k, v in layers.items() if k != "layers"}
    ref_layers["layers"] = [
        {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
         for k, v in layer.items()} for layer in layers["layers"]]
    moments = ref_shd.moment_pspecs(ref_cfg, fake, ref_layers)
    layout = reference_layout(cfg)
    plen = len(cfg.block_pattern)
    n_stacked = hybrid_grouping(cfg)[0] * plen

    def spec_of(i: int, leaf: str):
        if layout == "blocks":
            return tuple(stacked["blocks"][leaf])[1:]
        if layout == "layers":
            return tuple(stacked["layers"][i][leaf])
        if i < n_stacked:
            return tuple(stacked["groups"][i % plen][leaf])[1:]
        return tuple(stacked["tail"][i - n_stacked][leaf])

    for n, codes in got["placements"].items():
        if n.startswith("blocks."):
            _, i, leaf = n.split(".")
            spec = spec_of(int(i), leaf)
            mspec = moments["layers"][int(i)][leaf]
        else:
            spec, mspec = stacked[n], moments[n]
        assert codes == _codes(spec, names), n
        assert got["moments"][n] == _codes(mspec, names), n


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_leaf_carries_the_reference_placements(mesh, sharded_runs):
    shape, names = MESHES[mesh]
    got = sharded_runs(mesh)["1-False"]
    _assert_reference_placements(got, ARCH, {}, shape, names)
    if "pod" in names:      # ZeRO over 'pod' reaches the norms' moments
        assert got["moments"]["blocks.0.attn_norm"][0] == 0
        assert got["placements"]["blocks.0.attn_norm"][0] == -1


def test_rows_follow_batch_pspec(sharded_runs):
    """Rank 0 reads the first block of rows; (1, 2) does not split the
    batch (its 'data' has one rank), (pod 2, data 2) splits it four
    ways."""
    assert sharded_runs("2x1")["1-False"]["rows"] == [0, BATCH // 2]
    assert sharded_runs("1x2")["1-False"]["rows"] == [0, BATCH]
    assert sharded_runs("pod2x2x1")["1-False"]["rows"] == [0, BATCH // 4]


def test_checkpoint_restores_across_meshes_bit_equal(tmp_path):
    out = _run_ranks({"kind": "ckpt"}, 2, tmp_path)
    assert out["step"] == STEPS
    (p_a, mu_a), (p_b, mu_b) = out["saved"], out["restored"]
    for n in p_a:
        assert torch.equal(p_a[n], p_b[n]), n
        assert torch.equal(mu_a[n], mu_b[n]), n
    # restored onto (1, 2)'s placements: wq split by column over 'model'
    assert out["placements"]["blocks.0.wq"] == [0, 1]
    # and in one process, without a mesh
    cfg = get_config(ARCH, smoke=True)
    t = Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path / "ck")),
                "cpu", BATCH, SEQ)
    model, opt = t.init_state()
    restored, meta = CheckpointManager(str(tmp_path / "ck")).restore(
        t.state(model, opt))
    assert meta["data_step"] == STEPS
    for n in p_a:
        assert torch.equal(restored["params"][n], p_a[n]), n


def _torchrun(args, tmp_path, nproc=2):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train",
         "--arch", ARCH, "--smoke", "--device", "cpu", "--global-batch",
         "4", "--seq-len", "16", "--checkpoint-dir", str(tmp_path / "ck"),
         *args], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=TIMEOUT)


def test_launch_train_model_parallel_under_two_ranks(tmp_path):
    proc = _torchrun(["--steps", "2", "--model-parallel", "2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final loss:" in proc.stdout
    assert os.listdir(tmp_path / "ck") == ["step_000000000002"]
    proc = _torchrun(["--steps", "1", "--model-parallel", "3"], tmp_path)
    assert proc.returncode != 0
    assert "does not divide" in proc.stderr


# ---------------------------------------------------------------------------
# the other families
# ---------------------------------------------------------------------------

#: arch -> config overrides: recurrentgemma at 5 layers, one (rec, rec,
#: attn) group and a 2-layer tail
FAMILIES = {"mixtral-8x7b": {}, "mamba2-370m": {},
            "recurrentgemma-2b": {"n_layers": 5}}
FAMILY_VARIANTS = [(1, False), (2, True)]
#: world size -> the meshes its ranks run, (data, model)
FAMILY_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """(arch, "DxM") -> the sharded runs of each of FAMILY_VARIANTS: one
    group of ranks per world size runs every family on its meshes."""
    out = {}
    for world, shapes in FAMILY_MESHES.items():
        out.update(_run_ranks(
            {"kind": "families", "archs": list(FAMILIES.items()),
             "shapes": shapes, "variants": FAMILY_VARIANTS}, world,
            tmp_path_factory.mktemp(f"families{world}")))
    return out


@pytest.fixture(scope="module")
def family_one_process(tmp_path_factory):
    cache = {}

    def get(arch, accum, compress):
        if (arch, accum, compress) not in cache:
            tc = TrainConfig(
                lr=LR, warmup_steps=1, total_steps=10, grad_accum=accum,
                compress_grads=compress, checkpoint_every=1000,
                checkpoint_dir=str(tmp_path_factory.mktemp("one")))
            cfg = get_config(arch, smoke=True).with_(**FAMILIES[arch])
            t = Trainer(cfg, tc, "cpu", BATCH, SEQ)
            hist = t.run(STEPS, log_every=0)
            cache[arch, accum, compress] = (hist, {
                n: p.detach().clone() for n, p in
                t.model.named_parameters()})
        return cache[arch, accum, compress]
    return get


@pytest.mark.parametrize("accum,compress", FAMILY_VARIANTS)
@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_sharded_step_matches_one_process(
        arch, mesh, accum, compress, family_runs, family_one_process):
    """mixtral runs tensor parallel on each expert's F where 'model' has
    two ranks (routing and dispatch replicated); mamba2
    (``tensor_parallel=False``) is purely data parallel, its rows split
    over 'model' too, and recurrentgemma (its recurrent blocks) runs
    gathered over 'model'.  Each within the tolerances above of one
    process."""
    got = family_runs[arch, mesh][f"{accum}-{compress}"]
    _assert_matches(got, *family_one_process(arch, accum, compress))
    assert got["tp"] == (arch == "mixtral-8x7b" and mesh.endswith("x2"))
    d, m = (int(x) for x in mesh.split("x"))
    assert got["rows"] == [0, BATCH // (d * m if arch == "mamba2-370m"
                                        else d)]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_leaves_carry_the_reference_placements(arch, mesh,
                                                      family_runs):
    """Including the MoE experts' ``_MOE_3D`` rule (experts replicated,
    F over 'model', D over 'data'), the ssm's placements without 'model'
    and the hybrid's ``groups`` stacks and ``tail`` layers."""
    shape = tuple(int(d) for d in mesh.split("x"))
    got = family_runs[arch, mesh]["1-False"]
    _assert_reference_placements(got, arch, FAMILIES[arch], shape,
                                 ("data", "model"))
    if arch == "mixtral-8x7b" and mesh == "2x2":
        assert got["placements"]["blocks.0.w_gate"] == [1, 2]
        assert got["placements"]["blocks.0.w_down"] == [2, 1]


def test_hybrid_checkpoint_restores_across_meshes_bit_equal(tmp_path):
    """recurrentgemma at 5 layers: written under (2, 1), restored under
    (1, 2), every parameter and moment bit for bit."""
    out = _run_ranks({"kind": "ckpt", "arch": "recurrentgemma-2b",
                      "over": FAMILIES["recurrentgemma-2b"]}, 2, tmp_path)
    assert out["step"] == STEPS
    (p_a, mu_a), (p_b, mu_b) = out["saved"], out["restored"]
    assert set(p_a) == set(p_b) and "blocks.4.w_gate" in p_a
    for n in p_a:
        assert torch.equal(p_a[n], p_b[n]), n
        assert torch.equal(mu_a[n], mu_b[n]), n


def _explicit_batches(cfg) -> list:
    """STEPS seeded batches of the vlm's (tokens after ``vision``) or the
    audio's (``frames`` and ``labels``) inputs."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(i)
        if cfg.family == "audio":
            b = {"frames": rng.normal(size=(BATCH, SEQ, cfg.frontend_dim)),
                 "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}
        else:
            b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
                 "vision": rng.normal(size=(BATCH, cfg.vision_tokens,
                                            cfg.d_model))}
        out.append({k: torch.from_numpy(v).float() if v.dtype == np.float64
                    else torch.from_numpy(v) for k, v in b.items()})
    return out


@pytest.mark.parametrize("arch,shape", [("internvl2-76b", (1, 2)),
                                        ("internvl2-76b", (2, 1)),
                                        ("hubert-xlarge", (1, 2))])
def test_sharded_step_trains_vlm_and_audio_batches(arch, shape, tmp_path):
    """``make_sharded_train_step`` on explicit batches (the Trainer's
    token pipeline makes neither input): internvl2 tensor parallel at
    model 2 (the patch embeddings enter replicated before the split
    lookup, the loss on the gathered text logits) and on (2, 1); hubert
    gathered over 'model'.  Within the tolerances above of the
    one-device ``make_train_step``."""
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    cfg = get_config(arch, smoke=True)
    batches = _explicit_batches(cfg)
    torch.save(batches, tmp_path / "batches.pt")
    got = _run_ranks({"kind": "explicit", "arch": arch, "shape": shape,
                      "names": ("data", "model"),
                      "batches": str(tmp_path / "batches.pt")},
                     int(np.prod(shape)), tmp_path)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, TrainConfig(lr=LR, warmup_steps=1,
                                            total_steps=10))
    opt = adamw_init(dict(model.named_parameters()))
    hist = []
    for b in batches:
        model, opt, m = step(model, opt, b)
        hist.append({k: float(v) for k, v in m.items()})
    _assert_matches(got, hist, {n: p.detach() for n, p in
                                model.named_parameters()})
    assert got["tp"] == (arch == "internvl2-76b" and shape[1] == 2)
