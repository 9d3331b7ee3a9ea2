"""The port's dry run (``repro_torch.launch.dryrun``), its roofline
(``launch/roofline.py``), ``configs.registry.input_specs`` and the sharded
inference it runs (``serve/parallel.py``), on the CPU.

The reference's own dry run fails in this container
(``tests/test_system.py::test_dryrun_entry_small_mesh``), so nothing
holds the port's numbers to the reference's.  What is held instead:

  * ``input_specs`` gives the reference's shapes and dtypes for every
    cell of ``all_cells()``, with and without ``scaled_batch``;
  * the copied roofline arithmetic gives the reference's numbers on the
    same terms and rates, and ``model_flops`` the reference's for every
    cell;
  * one rank's step measured on a 4-rank ``fake`` group equals the same
    step run for real on 4 gloo ranks (qwen3-8b smoke, meshes (1, 4) and
    (2, 2), train and decode): the FLOPs, the collective bytes and counts
    by kind, the bytes moved, the arguments and the peak;
  * a smoke train cell's FLOPs per rank against ``model_flops / chips``,
    the gap stated as a formula;
  * each rank's parameter and moment bytes at the production meshes
    equal what the placements of ``train/sharding.py``'s rules give;
  * the sharded prefill and decode on gloo ranks match one device within
    ``tests/test_torch_families.py``'s tolerance, every family, with the
    kv cache split by heads or by sequence (a ring that wraps);
  * the committed pod1 results: every cell the reference supports ``ok``;
  * the full pod1 and pod2 sweep, one ``slow`` test, runs only where
    ``-m slow`` selects it (about an hour on one CPU core).

Each multi-rank run starts its ranks as subprocesses on a free port, with
a timeout, so a fault cannot hang the suite.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.registry import input_specs as ref_input_specs
from repro.launch import roofline as ref_rf
from repro_torch.configs import get_config
from repro_torch.configs.registry import SHAPES, all_cells, input_specs
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import free_port

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
TOL = dict(rtol=1e-4, atol=1e-4)          # test_torch_families.py's
CELLS = [(a, s) for a, s, _, _ in all_cells()]
_JAX_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
               jnp.float32: torch.float32}

WORKER = r"""
import json, os, sys, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import destroy, init_distributed

job = json.loads(sys.argv[1])


def mesh_of(shape):
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data",
                                                                 "model"))


def measure():
    cfg = get_config(job["arch"], smoke=True)
    out = {}
    for shape in job["meshes"]:
        mesh = mesh_of(shape)
        for kind, seq, batch in job["cells"]:
            m = dryrun.measure_cell(cfg, ShapeCell(kind, kind, seq, batch),
                                    mesh, device="cpu", fake=job["fake"])
            out[f"{kind}-{shape[0]}x{shape[1]}"] = m
    return out


def serve():
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import decode_step, prefill
    from repro_torch.serve.parallel import ShardedServer
    out = {}
    b, s, ctx, steps = job["batch"], job["seq"], job["context"], job["steps"]
    for arch, shape in job["cases"]:
        if tuple(shape) == (1, 1) or \
                shape[0] * shape[1] != dist.get_world_size():
            continue
        cfg = get_config(arch, smoke=True)
        mesh = mesh_of(shape)
        g = torch.Generator().manual_seed(1)

        def model():
            return init_params(cfg, torch.Generator().manual_seed(0), "cpu")

        if cfg.is_encoder:
            frames = torch.randn(b, s, cfg.frontend_dim, generator=g)
            with torch.inference_mode():
                want = [model()(frames=frames)]
            srv = ShardedServer(model(), mesh, decode=False, context=s)
            rows = srv.rows(b)
            got = [srv.encode(frames[rows])]
        else:
            toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
            nxt = torch.randint(0, cfg.vocab_size, (steps, b, 1),
                                generator=g)
            kw = {}
            if cfg.family == "vlm":
                kw["vision"] = torch.randn(b, cfg.vision_tokens, cfg.d_model,
                                           generator=g)
            one = model()
            lp, cache = prefill(one, toks, ctx, **kw)
            want = [lp]
            for i in range(steps):
                lg, cache = decode_step(one, nxt[i], cache)
                want.append(lg)
            srv = ShardedServer(model(), mesh, decode=False, context=ctx)
            rows = srv.rows(b)
            lp, block = srv.prefill(toks[rows],
                                    **{k: v[rows] for k, v in kw.items()})
            got = [lp]
            dec = ShardedServer(model(), mesh, decode=True, context=ctx)
            for i in range(steps):
                lg, block = dec.decode_step(nxt[i][rows], block)
                got.append(lg)
            srv = dec
        key = f"{arch}-{shape[0]}x{shape[1]}"
        out[key] = {"got": [t.clone() for t in got],
                    "want": [t[rows].clone() for t in want],
                    "tp": srv.tp is not None,
                    "kv_share": srv.tp.kv_share if srv.tp else 0,
                    "kv_split": srv.splits.get("kv_k")}
    return out


if job["fake"]:
    with dryrun.fake_group(job["world"]):
        out = measure()
    rank = 0
else:
    init_distributed("cpu")
    rank = dist.get_rank()
    out = measure() if job["kind"] == "measure" else serve()
if rank == 0:
    torch.save(out, job["out"])
destroy()
"""


def _run(job: dict, world: int, tmp: Path) -> dict:
    """``world`` gloo ranks of WORKER (or one process on a fake group of
    ``world``), rank 0's results."""
    job = dict(job, out=str(tmp / "out.pt"), world=world)
    port = free_port()
    n = 1 if job.get("fake") else world
    procs = []
    for r in range(n):
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


# ---- input_specs ----
@pytest.mark.parametrize("scaled", [None, 8])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape, scaled):
    want = ref_input_specs(ref_get_config(arch), shape, scaled_batch=scaled)
    got = input_specs(get_config(arch), shape, scaled_batch=scaled)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == _JAX_DTYPES[w.dtype.type], k


# ---- roofline ----
TERMS = [dict(flops_per_device=3.1e14, bytes_per_device=2.2e13,
              collective_breakdown={"all-gather": 4.1e10, "all-reduce": 9.9e10,
                                    "reduce-scatter": 0, "all-to-all": 0,
                                    "collective-permute": 0},
              chips=256, model_flops_total=5.15e16),
         dict(flops_per_device=2.0e9, bytes_per_device=7.0e12,
              collective_breakdown={"all-gather": 1.0, "all-reduce": 2.5e9},
              chips=512, model_flops_total=0.0),
         dict(flops_per_device=0.0, bytes_per_device=0.0,
              collective_breakdown={}, chips=1, model_flops_total=1.0)]


@pytest.mark.parametrize("terms", TERMS)
def test_roofline_arithmetic_matches_the_reference(terms, monkeypatch):
    """The reference's function on the port's rates gives the port's
    numbers, field for field."""
    monkeypatch.setattr(ref_rf, "PEAK_FLOPS", rf.PEAK_FLOPS)
    monkeypatch.setattr(ref_rf, "HBM_BW", rf.HBM_BW)
    monkeypatch.setattr(ref_rf, "ICI_BW", rf.LINK_BW)
    assert rf.roofline_from_terms(**terms).to_dict() == \
        ref_rf.roofline_from_terms(**terms).to_dict()


def test_roofline_rates_are_the_h100s():
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert dryrun.CONSTANTS["hbm_bytes"] == 80e9


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_matches_the_reference(arch, shape):
    from repro.configs.registry import SHAPES as REF_SHAPES
    assert rf.model_flops(get_config(arch), SHAPES[shape]) == \
        ref_rf.model_flops(ref_get_config(arch), REF_SHAPES[shape])


def test_comm_counter_sorts_both_operator_families():
    import torch.distributed  # noqa: F401  (registers the c10d operators)
    import torch.distributed._functional_collectives  # noqa: F401
    ops = torch.ops
    assert rf.collective_kind(
        ops._c10d_functional.all_gather_into_tensor.default) == "all-gather"
    assert rf.collective_kind(
        ops._c10d_functional.reduce_scatter_tensor.default) == \
        "reduce-scatter"
    assert rf.collective_kind(
        ops._c10d_functional.all_to_all_single.default) == "all-to-all"
    assert rf.collective_kind(ops._c10d_functional.all_reduce.default) == \
        "all-reduce"
    assert rf.collective_kind(ops._c10d_functional.wait_tensor.default) \
        is None
    assert rf.collective_kind(ops.aten.mm.default) is None


# ---- one rank's step: a fake group against gloo ----
SMOKE_CELLS = [("train", 16, 8), ("decode", 32, 8)]
SMOKE_MESHES = [(1, 4), (2, 2)]


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    job = {"kind": "measure", "arch": "qwen3-8b", "cells": SMOKE_CELLS,
           "meshes": SMOKE_MESHES}
    fake = _run(dict(job, fake=True), 4, tmp_path_factory.mktemp("fake"))
    real = _run(dict(job, fake=False), 4, tmp_path_factory.mktemp("gloo"))
    return fake, real


@pytest.mark.parametrize("key", ["train-1x4", "train-2x2", "decode-1x4",
                                 "decode-2x2"])
def test_fake_group_counts_what_gloo_runs(key, measured):
    """The same step measured on fake tensors over a fake group and run
    for real over gloo: every count equal, exactly."""
    fake, real = measured[0][key], measured[1][key]
    for k in ("flops", "collectives", "collective_counts", "bytes",
              "argument_bytes", "peak_bytes", "tensor_parallel",
              "kv_share", "rows"):
        assert fake[k] == real[k], k
    assert fake["tensor_parallel"]
    assert fake["kv_share"] == (2 if key.endswith("1x4") else 1)
    assert sum(fake["collectives"].values()) > 0


def test_smoke_train_flops_against_model_flops(measured):
    """qwen3-8b smoke, 8 x 16 tokens on (2, 2): each rank runs 4 rows on
    half of every head, FFN unit and vocabulary column, so its FLOPs are
    (6 N_mm T + 12 L B S^2 H hd) / 4 exactly, T the tokens, N_mm the
    weights the products read (the padded head, not the embedding
    table's lookup) and the second term attention's scores and weighted
    values (forward and backward, nothing skipped by the causal mask).
    Against model_flops / chips (6 N T / 4, N counting the embedding and
    the norms) that is 0.864: the smoke model's embedding table is 15.4%
    of its N and makes no FLOPs, attention adds 1.9%.  (At full width the
    table is a small share and attention and remat's recompute add:
    qwen3-8b train_4k pod1 is 1.38, ``results/dryrun_torch``.)"""
    cfg = get_config("qwen3-8b", smoke=True)
    _, s, b = SMOKE_CELLS[0]
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    h, hk = cfg.n_heads, cfg.n_kv_heads
    per_layer = d * h * hd * 2 + 2 * d * hk * hd + 3 * d * cfg.d_ff
    n_mm = L * per_layer + d * cfg.padded_vocab
    tokens = b * s
    want = (6 * n_mm * tokens + 12 * L * b * s * s * h * hd) / 4
    got = measured[0]["train-2x2"]["flops"]
    assert got == want
    model = rf.model_flops(cfg, type("Cell", (), {
        "kind": "train", "global_batch": b, "seq_len": s}))
    ratio = got / (model / 4)
    assert ratio == pytest.approx(
        (n_mm + 2 * L * s * h * hd) / cfg.param_count())
    assert round(ratio, 3) == 0.864


PLACEMENT_CASES = [("qwen3-8b", False), ("mixtral-8x7b", True)]

PLACEMENT_WORKER = r"""
import json, sys, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.sharding import moment_placements, param_placements
from repro_torch.optim import resolve_moment_dtype

arch, multi_pod = sys.argv[1], sys.argv[2] == "1"
cfg = get_config(arch)
with dryrun.fake_group(512 if multi_pod else 256):
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    with FakeTensorMode():
        _, args, facts = dryrun.build_step(
            cfg, dryrun.SHAPES["train_4k"], mesh, device="cpu")
        got = {k: dryrun._nbytes(v) for k, v in args.items()}
        from repro_torch.models.transformer import Transformer
        shapes = {n: (tuple(p.shape), p.element_size())
                  for n, p in Transformer(cfg, "cpu").named_parameters()}
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def local(shape, pl):
        shape = list(shape)
        for p, n in zip(pl, mesh.shape):
            if p.is_shard():
                assert shape[p.dim] % n == 0
                shape[p.dim] //= n
        out = 1
        for x in shape:
            out *= x
        return out

    mdt = torch.empty((), dtype=resolve_moment_dtype(cfg.moment_dtype))
    pp, mp = param_placements(cfg, mesh), moment_placements(cfg, mesh)
    want = {"params": sum(local(s, pp[n]) * e for n, (s, e) in shapes.items()),
            "moments": 2 * sum(local(s, mp[n]) * mdt.element_size()
                               for n, (s, _) in shapes.items())}
print(json.dumps({"got": got, "want": want, **facts}))
"""


@pytest.mark.parametrize("arch,multi_pod", PLACEMENT_CASES)
def test_param_and_moment_bytes_follow_the_rules(arch, multi_pod):
    """At the production mesh (qwen3-8b on pod1; mixtral-8x7b on pod2,
    its experts by ``_MOE_3D`` and its moments ZeRO-split over 'pod'),
    each rank's parameter and moment blocks are what
    ``param_placements`` / ``moment_placements`` give: the whole model's
    bytes over the shards of each leaf."""
    res = subprocess.run(
        [sys.executable, "-c", PLACEMENT_WORKER, arch,
         "1" if multi_pod else "0"], env=dict(os.environ,
                                              PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["got"]["params"] == out["want"]["params"]
    assert out["got"]["moments"] == out["want"]["moments"]
    assert out["tensor_parallel"] and out["kv_share"] == 2
    cfg = get_config(arch)
    # nearly every leaf splits over 'data' x 'model' (256 ranks); 'pod'
    # carries data parallelism only, and splits the moments alone
    n = cfg.param_count()
    assert out["got"]["params"] < 1.1 * 2 * n / 256
    moment = 2 * (2 if cfg.moment_dtype == "bfloat16" else 4) * n
    assert out["got"]["moments"] < 1.1 * moment / (512 if multi_pod else 256)


# ---- the sharded prefill and decode against one device ----
SERVE = dict(batch=4, seq=20, context=32, steps=3)
SERVE_CASES = [("qwen3-8b", (1, 4)), ("qwen3-8b", (2, 2)),
               ("minicpm-2b", (1, 4)), ("mixtral-8x7b", (1, 4)),
               ("internvl2-76b", (1, 4)), ("recurrentgemma-2b", (2, 2)),
               ("mamba2-370m", (1, 4)), ("hubert-xlarge", (2, 2)),
               ("minicpm-2b", (1, 2)), ("grok-1-314b", (2, 2))]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = {}
    for world in (4, 2):
        out.update(_run(dict(SERVE, kind="serve", fake=False,
                             cases=SERVE_CASES), world,
                        tmp_path_factory.mktemp(f"serve{world}")))
    return out


@pytest.mark.parametrize("arch,mesh", SERVE_CASES)
def test_sharded_prefill_and_decode_match_one_device(arch, mesh, served):
    """Each rank's rows of the prefill logits (the encoder's forward for
    hubert) and of 3 decode steps against one device's.  qwen3-8b on
    (1, 4): tensor parallel with 2 ranks a kv head, the cache split by
    sequence (the softmax reduced over 'model'); on (2, 2) split by kv
    head.  minicpm on (1, 4) gathered over 'model', its 6 heads not
    dividing 4, the cache by sequence; on (1, 2) tensor parallel with the
    decode layout's d_model-split tied embedding.  mixtral's and the
    hybrid's windowed caches (16 entries for a 20-token prompt) are rings
    that wrap, split by sequence."""
    cfg = get_config(arch, smoke=True)
    r = served[f"{arch}-{mesh[0]}x{mesh[1]}"]
    assert len(r["got"]) == (1 if cfg.is_encoder else 1 + SERVE["steps"])
    for g, w in zip(r["got"], r["want"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    from repro_torch.models.tensor_parallel import TensorParallel
    assert r["tp"] == (cfg.tensor_parallel and
                       TensorParallel.fits(cfg, mesh[1]))
    if arch == "qwen3-8b":
        assert (r["kv_share"], r["kv_split"]) == \
            ((2, 2) if mesh == (1, 4) else (1, 3))
    if arch in ("mixtral-8x7b", "recurrentgemma-2b", "minicpm-2b") and \
            mesh[1] == 4 or arch == "recurrentgemma-2b":
        assert r["kv_split"] == 2        # by sequence


# ---- the results ----
def test_committed_pod1_results_hold_every_supported_cell():
    """The pod1 sweep committed under ``results/dryrun_torch``: a file
    for every cell, ``ok`` for every cell the reference supports, on the
    H100 constants; qwen3-8b train_4k tensor parallel with 2 ranks a kv
    head, within 2x of model_flops / 256 and under 80 GB a rank."""
    for arch, shape, ok, _ in all_cells():
        path = dryrun.RESULTS_DIR / f"{arch}__{shape}__pod1.json"
        res = json.loads(path.read_text())
        assert res["supported"] == ok, path.name
        assert res.get("ok", False) == ok, (path.name, res.get("error"))
        assert res["constants"] == dryrun.CONSTANTS
    q = json.loads((dryrun.RESULTS_DIR /
                    "qwen3-8b__train_4k__pod1.json").read_text())
    assert q["tensor_parallel"] and q["kv_share"] == 2
    assert q["flops_over_model_flops_per_chip"] <= 2.0
    assert q["memory"]["peak_bytes"] < 80e9 and q["fits_h100"]


def test_cli_writes_one_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` for one decode cell at pod1
    writes its JSON to ``--out`` (never the committed results)."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--mesh", "pod1",
         "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads((tmp_path / "mamba2-370m__decode_32k__pod1.json")
                     .read_text())
    assert out["ok"] and out["chips"] == 256
    assert out["device"] == dryrun.fake_device("cuda")
    assert out["roofline"]["flops_per_device"] > 0


@pytest.mark.slow
def test_full_sweep_pod1_and_pod2(tmp_path, request):
    """Every cell of ``all_cells()`` at pod1 and pod2, one process an
    arch, three at a time: a JSON each, ``ok`` where the reference
    supports the cell.  About an hour on the CPU, so it runs only where
    ``-m slow`` selects it."""
    if "slow" not in (request.config.getoption("-m") or ""):
        pytest.skip("the full sweep takes about an hour: run it with "
                    "-m slow")
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def one(arch):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "both", "--out", str(tmp_path)], env=env,
            cwd=ROOT, capture_output=True, text=True, timeout=3 * 3600)

    archs = sorted({a for a, _ in CELLS})
    with ThreadPoolExecutor(3) as pool:
        runs = list(pool.map(one, archs))
    for arch, res in zip(archs, runs):
        assert res.returncode == 0, (arch, res.stdout[-3000:])
    for arch, shape, ok, _ in all_cells():
        for mesh in ("pod1", "pod2"):
            res = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                             .read_text())
            assert res.get("ok", False) == ok, (arch, shape, mesh)
