"""The split over 'model' that the reference's XLA partitioner makes,
written out by the port (``models/tensor_parallel.py``), on gloo ranks on
the CPU, held against one process of the port (itself held against the
reference's jitted step and its serving by ``test_torch_train_step.py``,
``test_torch_train_families.py`` and ``test_torch_families.py``):

  * the sequence-parallel residual stream (Megatron-SP): qwen3-8b smoke on
    (1, 4), each rank's stream between blocks (rows, S / 4, D), read by
    forward hooks on the blocks;
  * sequence-parallel attention where the query heads do not divide
    'model' (the reference's ``_constrain_qkv``): minicpm-2b smoke on
    (1, 4), its 6 heads against 4 ranks;
  * tensor parallelism of the hybrid's RG-LRU blocks: recurrentgemma-2b
    at 5 layers and 3 heads on (1, 2), its ``d_rnn`` of 48 split and its
    attention sequence parallel;
  * the audio GeLU MLP: hubert-xlarge smoke on (1, 2), its heads and MLP
    split;
  * a sequence that does not divide 'model' (18 positions on 4 ranks),
    which stays whole on every rank, as the reference's ``_resolve``
    replicates a dim that does not divide.

Training: two steps, the loss and the gradient norm within rtol 1e-5 and
the parameters within ``test_torch_sharded_train.py``'s tolerances (4 lr,
at most 1 in 10,000 elements past 1e-5).  Serving: the prefill logits
(the encoder's forward for hubert) and 3 decode steps of each rank's rows
within ``test_torch_families.py``'s tolerance (rtol = atol = 1e-4).

Each run starts its ranks as subprocesses on a free port, with a timeout,
so a fault cannot hang the suite.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import free_port
from repro_torch.models.tensor_parallel import (ATTN_WEIGHTS, NORMS,
                                               TensorParallel)
from repro_torch.train import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, STEPS = 8, 16, 2
TIMEOUT = 240
LR = 1e-3
P_ATOL = 1e-5
OUTLIERS = 1e-4
TOL = dict(rtol=1e-4, atol=1e-4)        # test_torch_families.py's
SERVE = dict(batch=4, seq=20, context=32, steps=3)
HYBRID = {"n_layers": 5, "n_heads": 3}

#: name -> (arch, config overrides, (data, model), sequence length)
TRAIN_CASES = {
    "minicpm-2b": ("minicpm-2b", {}, (1, 4), SEQ),
    "recurrentgemma-2b": ("recurrentgemma-2b", HYBRID, (1, 2), SEQ),
    "hubert-xlarge": ("hubert-xlarge", {}, (1, 2), SEQ),
    "qwen3-8b": ("qwen3-8b", {}, (1, 4), SEQ),
    "minicpm-2b-odd": ("minicpm-2b", {}, (1, 4), 18),
}
SERVE_CASES = {
    "minicpm-2b": ("minicpm-2b", {}, (1, 4)),
    "recurrentgemma-2b": ("recurrentgemma-2b", HYBRID, (1, 2)),
    "hubert-xlarge": ("hubert-xlarge", {}, (1, 2)),
    "qwen3-8b": ("qwen3-8b", {}, (1, 4)),
}

WORKER = r"""
import json, os, sys, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import destroy, init_distributed

job = json.loads(sys.argv[1])
init_distributed("cpu")
world = dist.get_world_size()


def mesh_of(shape):
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def record(model, shapes):
    # each block's output: the residual stream between blocks
    for blk in model.blocks:
        blk.register_forward_hook(
            lambda m, i, o: shapes.add(tuple(o.shape)))


def tp_facts(tp):
    return {"tp": tp is not None,
            "seq_attn": bool(tp is not None and tp.seq_attn),
            "kv_share": tp.kv_share if tp is not None else 0}


def train(name, arch, over, shape, seq):
    from repro_torch.train import TrainConfig, Trainer
    cfg = get_config(arch, smoke=True).with_(**over)
    mesh = mesh_of(shape)
    if cfg.family == "audio":       # explicit batches: the loop feeds tokens
        from repro_torch.models.pspec_utils import activation_sharding
        from repro_torch.models.transformer import init_params
        from repro_torch.train.parallel import ShardedModel, batch_rows
        from repro_torch.train.trainer import make_sharded_train_step
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        sm = ShardedModel(model.requires_grad_(True), mesh)
        shapes = set()
        record(sm.module, shapes)
        opt = sm.init_opt(torch.float32)
        rows = batch_rows(mesh, job["train_batch"])
        step = make_sharded_train_step(cfg, TrainConfig(
            lr=1e-3, warmup_steps=1, total_steps=10), rows)
        hist = []
        with activation_sharding(mesh):
            for b in torch.load(job["batches"]):
                sm, opt, m = step(sm, opt,
                                  {k: v[rows[0]] for k, v in b.items()})
                hist.append({k: float(v) for k, v in m.items()})
    else:
        tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         checkpoint_dir=os.path.join(job["dir"], name),
                         checkpoint_every=1000)
        t = Trainer(cfg, tc, "cpu", job["train_batch"], seq, mesh=mesh)
        shapes = set()
        init = t.init_state

        def hooked():
            sm, opt = init()
            record(sm.module, shapes)
            return sm, opt

        t.init_state = hooked
        hist = [{k: h[k] for k in ("loss", "grad_norm", "lr")}
                for h in t.run(job["train_steps"], log_every=0)]
        sm = t.model
    stream = {"frames" if cfg.is_encoder else "tokens": torch.empty(0, seq)}
    return {"history": hist, "params": sm.full_state_dict(),
            "residual": sorted(shapes), "seq_split": sm.splits(stream),
            **tp_facts(sm.tp)}


def whole(srv, logits):
    # the vocabulary's blocks, which a split prefill leaves on the ranks
    if srv.tp is None:
        return logits
    from repro_torch.models.tensor_parallel import gather_cat
    return gather_cat(logits, -1, srv.tp.group, srv.tp.size)


def serve(arch, over, shape):
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import decode_step, prefill
    from repro_torch.serve.parallel import ShardedServer
    cfg = get_config(arch, smoke=True).with_(**over)
    mesh = mesh_of(shape)
    b, s, ctx, steps = job["batch"], job["seq"], job["context"], job["steps"]
    g = torch.Generator().manual_seed(1)

    def model():
        return init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    shapes = set()
    if cfg.is_encoder:
        frames = torch.randn(b, s, cfg.frontend_dim, generator=g)
        with torch.inference_mode():
            want = [model()(frames=frames)]
        srv = ShardedServer(model(), mesh, decode=False, context=s)
        record(srv.model, shapes)
        rows = srv.rows(b)
        split = srv.encode(frames[rows])
        got = [whole(srv, split)]
        dec = srv
    else:
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
        nxt = torch.randint(0, cfg.vocab_size, (steps, b, 1), generator=g)
        one = model()
        lp, cache = prefill(one, toks, ctx)
        want = [lp]
        for i in range(steps):
            lg, cache = decode_step(one, nxt[i], cache)
            want.append(lg)
        srv = ShardedServer(model(), mesh, decode=False, context=ctx)
        rows = srv.rows(b)
        split, block = srv.prefill(toks[rows])
        got = [whole(srv, split)]
        dec = ShardedServer(model(), mesh, decode=True, context=ctx)
        for i in range(steps):
            lg, block = dec.decode_step(nxt[i][rows], block)
            got.append(lg)
    return {"got": [t.clone() for t in got],
            "want": [t[rows].clone() for t in want], "split": split.clone(),
            "kv_split": dec.splits.get("kv_k"),
            "rec_split": dec.splits.get("rec_h"),
            "residual": sorted(shapes), **tp_facts(dec.tp)}


out = {}
for name, (kind, arch, over, shape, seq) in job["cases"].items():
    if shape[0] * shape[1] != world:
        continue
    out[name] = train(name, arch, over, shape, seq) if kind == "train" else \
        serve(arch, over, shape)
if dist.get_rank() == 0:
    torch.save(out, job["out"])
destroy()
"""


def _run_ranks(job: dict, world: int, tmp: Path) -> dict:
    """Start ``world`` gloo ranks of WORKER on a free port; rank 0's
    results."""
    job = dict(dict(train_batch=BATCH, train_steps=STEPS), **job,
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


def _audio_batches(cfg) -> list:
    """STEPS seeded batches of ``frames`` and ``labels``."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(i)
        out.append({"frames": torch.from_numpy(rng.normal(
            size=(BATCH, SEQ, cfg.frontend_dim))).float(),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (BATCH, SEQ)))})
    return out


@pytest.fixture(scope="module")
def batches_path(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("batches") / "audio.pt"
    torch.save(_audio_batches(get_config("hubert-xlarge", smoke=True)),
               path)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batches_path):
    """Every train and serve case, one group of ranks per world size."""
    cases = {f"train/{k}": ("train", *v) for k, v in TRAIN_CASES.items()}
    cases.update({f"serve/{k}": ("serve", a, o, m, 0)
                  for k, (a, o, m) in SERVE_CASES.items()})
    out = {}
    for world in (4, 2):
        out.update(_run_ranks(dict(SERVE, cases=cases,
                                   batches=batches_path), world,
                              tmp_path_factory.mktemp(f"w{world}")))
    return out


def _one_process(arch, over, seq, tmp: Path):
    """Two steps of one process: the Trainer's, or ``make_train_step`` on
    the audio batches."""
    cfg = get_config(arch, smoke=True).with_(**over)
    if cfg.family == "audio":
        from repro_torch.models.transformer import init_params
        from repro_torch.optim import adamw_init
        from repro_torch.train import make_train_step
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, TrainConfig(lr=LR, warmup_steps=1,
                                                total_steps=10))
        opt = adamw_init(dict(model.named_parameters()))
        hist = []
        for b in _audio_batches(cfg):
            model, opt, m = step(model, opt, b)
            hist.append({k: float(v) for k, v in m.items()})
        return hist, {n: p.detach() for n, p in model.named_parameters()}
    tc = TrainConfig(lr=LR, warmup_steps=1, total_steps=10,
                     checkpoint_every=1000, checkpoint_dir=str(tmp))
    t = Trainer(cfg, tc, "cpu", BATCH, seq)
    hist = t.run(STEPS, log_every=0)
    return hist, {n: p.detach().clone()
                  for n, p in t.model.named_parameters()}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_split_train_step_matches_one_process(name, runs, tmp_path):
    arch, over, mesh, seq = TRAIN_CASES[name]
    got = runs[f"train/{name}"]
    hist, params = _one_process(arch, over, seq, tmp_path)
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
    # every one of these families runs split over 'model' now
    cfg = get_config(arch, smoke=True).with_(**over)
    assert got["tp"]
    assert got["seq_attn"] == (cfg.n_heads % mesh[1] != 0)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_residual_stream_is_a_block_of_the_sequence(name, runs):
    """Each rank's stream between blocks is (rows, S / model, D) where
    the sequence divides 'model', and whole where it does not (the
    18-position case on 4 ranks)."""
    arch, over, mesh, seq = TRAIN_CASES[name]
    cfg = get_config(arch, smoke=True).with_(**over)
    got = runs[f"train/{name}"]
    split = seq % mesh[1] == 0
    assert got["seq_split"] == split
    assert got["residual"] == [(BATCH // mesh[0],
                                seq // mesh[1] if split else seq,
                                cfg.d_model)]


@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_split_prefill_and_decode_match_one_device(name, runs):
    """Each rank's rows of the prefill logits (the encoder's forward for
    hubert; this rank's block of their vocabulary, gathered to compare)
    and of 3 decode steps: the prompt's 20 positions split by
    sequence (5 a rank on 4 ranks, 10 on 2), decode's one token whole;
    minicpm's and the hybrid's attention sequence parallel with the
    cache split by sequence, the hybrid's RG-LRU states by ``d_rnn``."""
    arch, over, mesh = SERVE_CASES[name]
    cfg = get_config(arch, smoke=True).with_(**over)
    r = runs[f"serve/{name}"]
    assert len(r["got"]) == (1 if cfg.is_encoder else 1 + SERVE["steps"])
    for g, w in zip(r["got"], r["want"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert r["tp"]
    assert r["seq_attn"] == (cfg.n_heads % mesh[1] != 0)
    if r["seq_attn"]:
        assert r["kv_split"] == 2               # the cache by sequence
    if cfg.family == "hybrid":
        assert r["rec_split"] == 2              # rec_h by d_rnn
    if cfg.is_encoder:
        assert r["residual"] == [(SERVE["batch"], SERVE["seq"] // mesh[1],
                                  cfg.d_model)]
    # rank 0's block of the vocabulary, as the reference's prefill leaves
    # its logits sharded over 'model'
    n = cfg.padded_vocab // mesh[1]
    assert r["split"].shape[-1] == n
    assert torch.equal(r["split"], r["got"][0][..., :n])


# ---- the modes, without ranks ----
MODE_CASES = [("minicpm-2b", {}, 4, True), ("minicpm-2b", {}, 2, False),
              ("qwen3-8b", {}, 4, False), ("recurrentgemma-2b", HYBRID, 2,
                                           True),
              ("hubert-xlarge", {}, 2, False), ("mixtral-8x7b", {}, 2,
                                                False)]


@pytest.mark.parametrize("arch,over,size,seq_attn", MODE_CASES)
def test_modes_follow_the_heads(arch, over, size, seq_attn):
    """Attention splits by heads where the query heads divide the group
    and the kv heads split or are shared, else by sequence; every family
    but the ssm fits."""
    cfg = get_config(arch, smoke=True).with_(**over)
    assert TensorParallel.fits(cfg, size)
    assert TensorParallel.heads_split(cfg, size) == (not seq_attn)
    assert not TensorParallel.fits(get_config("mamba2-370m", smoke=True), 2)


@pytest.mark.parametrize("seq_attn", [False, True])
@pytest.mark.parametrize("seq", [False, True])
def test_partial_grads_follow_the_mode(seq, seq_attn):
    """The router always; the per-head norms where the heads split or
    the sequence does; the residual's norms with the sequence split, and
    sequence-parallel attention's weights then too."""
    tp = TensorParallel(None, 0, 2, seq=True, seq_attn=seq_attn)
    got = tp.partial_grads(seq)
    want = {"w_router"}
    if seq or not seq_attn:
        want |= {"q_norm", "k_norm"}
    if seq:
        want |= set(NORMS) | (set(ATTN_WEIGHTS) if seq_attn else set())
    assert got == want


def test_local_config_per_kind():
    """Sequence-parallel attention keeps the heads whole; a recurrent
    block reads no heads; both split ``d_ff``."""
    cfg = get_config("recurrentgemma-2b", smoke=True).with_(**HYBRID)
    tp = TensorParallel(None, 0, 2, seq=True, seq_attn=True)
    for kind in ("dense", "rec"):
        local = tp.local_config(cfg, kind)
        assert (local.n_heads, local.n_kv_heads, local.d_ff) == \
            (3, 1, cfg.d_ff // 2)
    tp = TensorParallel(None, 0, 2, kv_share=2)
    cfg = get_config("recurrentgemma-2b", smoke=True)
    assert (tp.local_config(cfg).n_heads, tp.local_config(cfg).n_kv_heads) \
        == (2, 1)
    assert tp.local_config(cfg, "rec").n_heads == cfg.n_heads
    assert not tp.splits(16) and \
        TensorParallel(None, 0, 4, seq=True).splits(16) and \
        not TensorParallel(None, 0, 4, seq=True).splits(18)
