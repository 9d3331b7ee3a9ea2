"""The kernels' temporaries in the dry run's peak
(``repro_torch.launch.dryrun``: ``TEMPORARIES``, ``StepMemTracker``).

``MemTracker`` is a dispatch mode: it counts each op's outputs, never
what an op's CUDA kernel allocates inside itself.  The dry run adds those
temporaries by rule.  What is held here, on the CPU:

  * one attention block's forward and backward under ``measure``, split
    by heads and sequence parallel (a fake 4-rank group, fake tensors):
    the peak rises over plain ``MemTracker``'s by exactly softmax
    backward's temporary, one float32 score block, and no count moves;
  * a whole smoke step of each kind (train, prefill, decode) on a fake
    4-rank mesh: the FLOPs, bytes moved, collectives and arguments equal
    plain ``MemTracker``'s run, and the peak rises by at most the
    temporary live at the new peak;
  * the rules on the shapes the card measured (``tools/torch_memtrace.py``);
  * every committed pod1 and pod2 result carries ``temp_bytes``.

On the card (``cuda``-marked, skipped here): each rule against one op
alone, ``max_memory_allocated`` during the op less what was allocated
before it and less its output.
"""
import json

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeCell, all_cells
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as attn
from repro_torch.models.tensor_parallel import TensorParallel

SOFTMAX_BWD = "aten._softmax_backward_data.default"
EINSUM = "aten.einsum.default"
SIZE = 4                       # the fake 'model' group
ROWS, SEQ = 2, 512


def measure_plain(step, args: dict) -> dict:
    """``measure`` as it was before the temporaries: plain
    ``MemTracker``."""
    mt = MemTracker()
    mt.track_external(*[t for ts in args.values() for t in ts])
    flops = FlopCounterMode(display=False)
    comm = rf.CommCounter()
    with flops, comm, mt:
        step()
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(comm.bytes),
            "collectives": dict(comm.collectives),
            "collective_counts": dict(comm.counts),
            "argument_bytes": {k: dryrun._nbytes(v)
                               for k, v in args.items()},
            "peak_bytes": int(sum(s.get("Total", 0) for s in
                                  mt.get_tracker_snapshot("peak").values()))}


def _attention_block(kind: str):
    """(step, arguments, the score block's bytes): one attention block's
    forward and backward on this rank, ``heads``: its share of the heads
    (qwen3-8b smoke, a kv head shared by two ranks); ``seq``: sequence
    parallel (minicpm-2b smoke, whose 6 heads do not divide 4), this
    rank's block of the sequence against the whole sequence's keys."""
    g = torch.Generator().manual_seed(0)
    group = torch.distributed.group.WORLD
    if kind == "heads":
        whole = get_config("qwen3-8b", smoke=True)
        tp = TensorParallel(group, 0, SIZE, kv_share=SIZE // whole.n_kv_heads)
        cfg, s = tp.local_config(whole), SEQ
    else:
        cfg = get_config("minicpm-2b", smoke=True)
        tp = TensorParallel(group, 0, SIZE, seq=True, seq_attn=True)
        s = SEQ // SIZE
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        shapes |= {"q_norm": (hd,), "k_norm": (hd,)}
    p = {k: (0.02 * torch.randn(v, generator=g)).requires_grad_()
         for k, v in shapes.items()}
    x = torch.randn((ROWS, s, d), generator=g).requires_grad_()
    positions = torch.arange(SEQ, dtype=torch.int32).expand(ROWS, SEQ)

    def step():
        if kind == "heads":
            y, _, _ = attn._attend(p, x, cfg, positions, True, 0)
        else:
            y, _, _ = attn.attend_seq_parallel(p, x, cfg, positions, True,
                                               0, tp)
        y.sum().backward()

    args = {"params": list(p.values()), "moments": [], "batch": [x],
            "cache": []}
    return step, args, ROWS * cfg.n_heads * s * SEQ * 4


def _both(build):
    """``build()``'s step measured twice on fresh tensors: under
    ``dryrun.measure`` and under :func:`measure_plain`."""
    out = []
    for fn in (dryrun.measure, measure_plain):
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, *rest = build()
            out.append(fn(step, args))
    return (*out, *rest)


@pytest.mark.parametrize("kind", ["heads", "seq"])
def test_attention_peak_rises_by_softmax_backwards_temporary(kind):
    """Forward and backward of one attention block: the peak sits in
    softmax's backward (the saved weights, the gradient, the op's output
    and, on the card, ``grad * output``), so it rises by one float32
    score block, the rule's bytes, and nothing else moves."""
    with dryrun.fake_group(SIZE):
        new, plain, block = _both(lambda: _attention_block(kind))
    assert new["temp_bytes"] == {SOFTMAX_BWD: block}
    assert new["temp_calls"] == {SOFTMAX_BWD: 1}
    assert new["temp_at_peak"] == block
    assert new["peak_bytes"] - plain["peak_bytes"] == block
    for k in ("flops", "bytes", "collectives", "collective_counts",
              "argument_bytes"):
        assert new[k] == plain[k], k
    assert new["flops"] > 0
    if kind == "seq":
        assert sum(new["collectives"].values()) > 0


@pytest.mark.parametrize("kind,seq,batch,model", [("train", 16, 8, 2),
                                                  ("prefill", 16, 8, 2),
                                                  ("decode", 32, 8, 1)])
def test_step_counts_do_not_move(kind, seq, batch, model):
    """qwen3-8b smoke's sharded step of each kind on a fake 4-rank mesh
    of ``model`` ranks a row (decode: (4, 1), where each rank's cache
    block keeps both kv heads, which einsum's reshape copies):
    FLOPs, bytes moved, collectives and arguments equal plain
    ``MemTracker``'s run; the peak rises by at most the temporary live
    at the new peak (0 where the peak is at no rule's op); train counts
    softmax backward's temporary, serving (autograd off, where einsum
    reaches the tracker whole) einsum's operand copies."""
    cfg = get_config("qwen3-8b", smoke=True)
    cell = ShapeCell(kind, kind, seq, batch)
    with dryrun.fake_group(SIZE):
        mesh = make_host_mesh(model=model, device="cpu")
        new, plain = _both(lambda: dryrun.build_step(
            cfg, cell, mesh, device="cpu")[:2])
    for k in ("flops", "bytes", "collectives", "collective_counts",
              "argument_bytes"):
        assert new[k] == plain[k], k
    assert 0 <= new["peak_bytes"] - plain["peak_bytes"] <= \
        new["temp_at_peak"]
    assert set(new["temp_bytes"]) == {SOFTMAX_BWD if kind == "train"
                                      else EINSUM}
    assert all(v > 0 for v in new["temp_bytes"].values())


@pytest.mark.parametrize("case", [
    # (equation, operands' (shape, stride), bytes on the H100)
    ("bshd,bthd->bhst", ([2, 32768, 2, 128], [8388608, 256, 128, 1]),
     ([2, 32768, 2, 128], [8388608, 256, 128, 1]), 134217728),
    ("bshgd,bthd->bhgst", ([8, 1, 8, 4, 128], [4096, 4096, 512, 128, 1]),
     ([8, 2048, 8, 128], [2097152, 1024, 128, 1]), 67108864)])
def test_einsum_rule_gives_what_the_card_measured(case):
    """qwen3-8b prefill_32k's and decode_32k's scores at pod1: the
    temporaries ``tools/torch_memtrace.py`` measured on an H100 80GB
    HBM3 (every one of the 72 calls of each share's step)."""
    eq, (s1, t1), (s2, t2), want = case
    with FakeTensorMode():
        ops = [torch.empty_strided(s, t) for s, t in ((s1, t1), (s2, t2))]
        got = dryrun.temporary_bytes(torch.ops.aten.einsum.default,
                                     (eq, ops), {})
    assert got == want


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float16)])
def test_softmax_backward_rule(dtypes):
    """One tensor of the gradient's shape in the product's dtype: the
    minicpm-2b train_4k share's (16, 36, 256, 4,096) float32 block is
    2,415,919,104 bytes, what the card measured on each of 40 calls."""
    g, y = dtypes
    with FakeTensorMode():
        grad = torch.empty((16, 36, 256, 4096), dtype=g)
        out = torch.empty((16, 36, 256, 4096), dtype=y)
        got = dryrun.temporary_bytes(
            torch.ops.aten._softmax_backward_data.default,
            (grad, out, -1, y), {})
    assert got == grad.numel() * torch.promote_types(g, y).itemsize
    if dtypes == (torch.float32, torch.float32):
        assert got == 2415919104


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _, _
                                        in all_cells()])
def test_committed_results_carry_temp_bytes(arch, shape, mesh):
    """Every committed result of a supported cell names its
    temporaries by op, their calls, and the one live at its peak, which
    the peak includes."""
    res = json.loads((dryrun.RESULTS_DIR / f"{arch}__{shape}__{mesh}.json")
                     .read_text())
    if not res["supported"]:
        assert "memory" not in res
        return
    mem = res["memory"]
    temps, calls = mem["temp_bytes"], mem["temp_calls"]
    assert set(temps) == set(calls) <= {SOFTMAX_BWD, EINSUM}
    assert all(v > 0 for v in temps.values())
    assert 0 <= mem["temp_at_peak"] <= max(temps.values(), default=0)
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["temp_at_peak"]
    if shape == "train_4k" and get_config(arch).family != "ssm":
        assert temps[SOFTMAX_BWD] > 0


# ---- on the card ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via `python -m "
                    "pytest -m cuda tests/test_torch_dryrun_temporaries.py`)")
    return torch.device("cuda")


def _alone(dev, op, *args):
    """``op(*args)`` on the card: (the bytes allocated while it ran
    beyond what was allocated before it and beyond its output, the
    rule's bytes).  A first call, not measured, allocates what a process
    keeps (cuBLAS's 32 MiB workspace).  Every tensor here is at least
    10 MiB and a multiple of 2 MiB, or under 1 MiB, so the caching
    allocator's blocks are the tensors' sizes (no unsplit remainder)."""
    op(*args)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = op(*args)
    peak = torch.cuda.max_memory_allocated(dev)
    nbytes = -(-out.untyped_storage().nbytes() // 512) * 512
    return peak - before - nbytes, dryrun.temporary_bytes(op, args, {})


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtypes", [
    ((2, 4, 256, 4096), (torch.float32, torch.float32)),
    ((4, 8, 512, 512), (torch.float32, torch.float32)),
    ((2, 4, 1024, 1024), (torch.float32, torch.float32)),
    ((4, 4, 512, 4096), (torch.bfloat16, torch.bfloat16))])
def test_softmax_backward_rule_on_card(cuda, shape, dtypes):
    torch.cuda.empty_cache()
    g = torch.Generator(cuda).manual_seed(0)
    grad = torch.randn(shape, generator=g, device=cuda, dtype=dtypes[0])
    y = torch.softmax(torch.randn(shape, generator=g, device=cuda),
                      -1).to(dtypes[1])
    got, rule = _alone(cuda, torch.ops.aten._softmax_backward_data.default,
                       grad, y, -1, dtypes[1])
    assert rule > 0 and got == rule


@pytest.mark.cuda
@pytest.mark.parametrize("eq,shapes,dtype", [
    ("bshd,bthd->bhst", ((2, 8192, 2, 128), (2, 8192, 2, 128)),
     torch.float32),
    ("bshgd,bthd->bhgst", ((8, 1, 8, 4, 128), (8, 2048, 8, 128)),
     torch.float32),
    ("bhgst,bthd->bshgd", ((8, 8, 4, 1, 2048), (8, 2048, 8, 128)),
     torch.bfloat16)])
def test_einsum_rule_on_card(cuda, eq, shapes, dtype):
    torch.cuda.empty_cache()
    g = torch.Generator(cuda).manual_seed(0)
    ops = [torch.randn(s, generator=g, device=cuda).to(dtype)
           for s in shapes]
    with torch.inference_mode():
        got, rule = _alone(cuda, torch.ops.aten.einsum.default, eq, ops)
    assert rule > 0 and got == rule
