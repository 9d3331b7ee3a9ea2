"""Device routing of the port's entry points, and the CUDA kernels on the
card.

The entry points run on CUDA unless the caller names the CPU, and raise
when no CUDA device is present; they never fall back to the CPU quietly.
The CUDA kernel wrappers refuse CPU tensors.  Tests that need the card are
marked ``cuda`` and skip without one (decided inside the test, never at
import).
"""
import asyncio

import numpy as np
import pytest
import torch

from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.calibrate import (PHASES, PhaseTimer,
                                        measure_program_phases)
from repro_torch.core.gate_ir import LogicGraph, random_graph
from repro_torch.core.scheduler import (build_megaprogram, compile_graph,
                                        execute_megaprogram_np,
                                        execute_program_np)
from repro_torch.core.spec import CompileSpec
from repro_torch.core.nullanet import (BinaryMLPConfig, init_binary_mlp,
                                       mlp_to_logic_network,
                                       train_binary_mlp)
from repro_torch.flow import FlowConfig, build_classifier, run_flow
from repro_torch.kernels import native
from repro_torch.kernels.logic_dsp import kernel as _k
from repro_torch.kernels.logic_dsp import ops
from repro_torch.kernels.xnor_gemm import (pack_pm1, xnor_and_popc_ref,
                                           xnor_gemm, xnor_packed_ref)
from repro_torch.kernels.xnor_gemm import kernel as _xk
from repro_torch.serve import (FrontDoor, LogicEngine, ProgramCache,
                               decode_step, init_decode_cache, prefill)
from repro_torch.configs import get_config
from repro_torch.examples import quickstart
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import backend_for
from repro_torch.models import logic_mlp
from repro_torch.models.transformer import Transformer, init_params


def _prog(seed=0, n_unit=8, n_gates=120, alloc="liveness"):
    g = random_graph(np.random.default_rng(seed), 8, n_gates, 6,
                     unary_frac=0.2, locality=16)
    return g, compile_graph(g, CompileSpec(n_unit=n_unit, alloc=alloc,
                                           optimize="none"))


def _bits(seed, batch, n):
    return np.random.default_rng(seed).integers(0, 2, (batch, n)).astype(bool)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via "
                    "`python -m pytest -m cuda tests/test_torch_device.py`)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# defaults and refusals (run everywhere)
# ---------------------------------------------------------------------------

def test_resolve_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.resolve_device("meta")


def _door_round(g, x, **kw):
    """One request through a fresh one-tenant FrontDoor."""
    async def go():
        async with FrontDoor(spec=CompileSpec(n_unit=8), capacity=64,
                             default_deadline_s=60.0, **kw) as door:
            door.register("t", g)
            return await door.submit("t", x)
    return asyncio.run(asyncio.wait_for(go(), timeout=120))


@pytest.mark.parametrize("entry", ["logic_infer_bits", "mega_infer_bits",
                                   "engine", "program_arrays",
                                   "phased_infer_bits", "measure_phases",
                                   "frontdoor", "calibration_name",
                                   "store_cache", "sharded_engine",
                                   "mesh_backend"])
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry,
                                                    tmp_path):
    g, p = _prog()
    mega = build_megaprogram([p], mode="chain")
    x = _bits(1, 40, 8)
    calls = {
        "logic_infer_bits": lambda **kw: ops.logic_infer_bits(p, x, **kw),
        "mega_infer_bits": lambda **kw: ops.mega_infer_bits(mega, x, **kw),
        "engine": lambda **kw: LogicEngine(CompileSpec(n_unit=8),
                                           capacity=64, **kw).serve(g, x),
        "program_arrays": lambda **kw: ops.program_arrays(p, **kw),
        "phased_infer_bits": lambda **kw: ops.phased_infer_bits(p, x,
                                                                **kw)[0],
        "measure_phases": lambda **kw: measure_program_phases(p, 32, reps=1,
                                                              **kw),
        "frontdoor": lambda **kw: _door_round(g, x, **kw),
        "calibration_name": lambda **kw: ops.calibration_name(**kw),
        "store_cache": lambda **kw: ProgramCache(
            store=ArtifactStore(tmp_path), **kw),
        "sharded_engine": lambda **kw: LogicEngine(
            CompileSpec(n_unit=8), capacity=64, shard=True,
            **kw).serve(g, x),
        "mesh_backend": lambda **kw: backend_for(**kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    out = calls[entry](device="cpu")
    if entry in ("logic_infer_bits", "mega_infer_bits", "engine",
                 "phased_infer_bits", "frontdoor", "sharded_engine"):
        np.testing.assert_array_equal(out, g.evaluate(x))


def test_kernel_wrappers_refuse_cpu_tensors():
    _, p = _prog()
    arrs = ops.program_arrays(p, "cpu")
    words = ops.pack_bits(torch.from_numpy(_bits(2, 40, 8)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _k.logic_cuda_call(arrs["rec"], words, arrs["output_addrs"],
                           n_addr=p.n_addr, plan=arrs["plan"])
    mega = build_megaprogram([p], mode="parallel")
    m = ops.mega_arrays(mega, "cpu")
    before = _k.launch_count()
    with pytest.raises(ValueError, match="CUDA tensor"):
        _k.mega_cuda_call(m["rec"], words, m["stage_table"], m["out_addrs"],
                          m["out_rows"], n_addr=mega.n_addr,
                          n_outputs=mega.n_outputs, chain=False,
                          handoff_rows=0, plan=m["plan"])
    assert _k.launch_count() == before


def test_cpu_tensors_take_the_plain_version_without_launching():
    g, p = _prog(3)
    x = _bits(3, 70, 8)
    before = _k.launch_count()
    np.testing.assert_array_equal(ops.logic_infer_bits(p, x, device="cpu"),
                                  g.evaluate(x))
    assert _k.launch_count() == before


@pytest.mark.parametrize("n_unit,want", [(1, 2), (8, 2), (256, 2),
                                         (29_056, 2), (29_057, 1),
                                         (58_112, 1)])
def test_cols_per_block(n_unit, want):
    """Two columns per block whatever the batch; one only when a step's
    results would not fit shared memory (a device-scratch program whose
    steps take two barriers; the ring gives way first)."""
    plan = _k.plan_launch(100_000, n_unit, one_barrier=False)
    assert plan.scratch == "device" and plan.cols == want
    assert plan.smem_bytes <= _k.MAX_SMEM


def test_cols_per_block_refuses_oversized_unit():
    with pytest.raises(ValueError, match="shared"):
        _k.plan_launch(100_000, 60_000, one_barrier=False)


@pytest.mark.parametrize("n_addr,n_unit,one,want", [
    # LeNet-5 fc1, monolithic and its widest partitioned stage
    (14_588, 256, True, ("shared", 2, 4, 14_588 * 8 + 4 * 256 * 8)),
    (4_937, 256, True, ("shared", 2, 4, 4_937 * 8 + 4 * 256 * 8)),
    # two barriers stage the step results in shared memory too
    (14_588, 256, False, ("shared", 2, 4,
                          14_588 * 8 + 4 * 256 * 8 + 256 * 2 * 4)),
    # past two columns' room, one column; past one column's, device memory
    (28_000, 256, True, ("shared", 2, 4, 28_000 * 8 + 4 * 256 * 8)),
    (29_000, 256, True, ("shared", 1, 4, 29_000 * 4 + 4 * 256 * 8)),
    (57_000, 256, True, ("shared", 1, 2, 57_000 * 4 + 2 * 256 * 8)),
    # the shared variant needs a ring of at least two steps
    (58_000, 256, True, ("device", 2, 4, 4 * 256 * 16)),
    # rows past 16 bits never take the packed records
    (70_000, 8, True, ("device", 2, 4, 4 * 8 * 16)),
    (8, 1, True, ("shared", 2, 4, 8 * 8 + 4 * 8)),
])
def test_plan_launch_picks_the_scratch_variant_by_size(n_addr, n_unit, one,
                                                       want):
    plan = _k.plan_launch(n_addr, n_unit, one)
    assert (plan.scratch, plan.cols, plan.ring, plan.smem_bytes) == want
    assert plan.one_barrier is one and plan.smem_bytes <= _k.MAX_SMEM


def test_plan_launch_pins_and_threads():
    """The plan carries the block's threads and shared memory, which the
    launch takes as they are; ``scratch`` pins the variant."""
    assert _k.plan_launch(100, 256, True, scratch="device").scratch == \
        "device"
    with pytest.raises(ValueError, match="shared"):
        _k.plan_launch(70_000, 8, True, scratch="shared")
    assert _k.plan_launch(100, 256, True).threads == 256
    assert _k.plan_launch(100, 1500, True).threads == 1024
    assert _k.plan_launch(100, 5, True).threads == 32
    device = _k.plan_launch(100, 256, True, scratch="device")
    assert device.cols == 2 and device.threads == 512
    for n_addr, n_unit, one in [(100, 256, True), (29_000, 256, False),
                                (70_000, 8, True)]:
        plan = _k.plan_launch(n_addr, n_unit, one)
        assert plan.cols in (1, 2)
        assert plan.smem_bytes == _k.smem_bytes(
            plan.scratch, n_unit, plan.cols, n_addr, plan.ring, one)
        assert plan.threads == _k.threads(plan.scratch, n_unit, plan.cols)


def test_forward_words_needs_the_launch_records_off_the_cpu():
    """Off the CPU ``forward_words`` takes the program's records and plan
    as given (built once per program) and never builds them per call."""
    _, p = _prog(4)
    a = ops.program_arrays(p, "cpu")
    words = torch.empty((p.n_inputs, 3), dtype=torch.int32, device="meta")
    before = _k.launch_count()
    with pytest.raises(ValueError, match="launch="):
        ops.forward_words(a["src_a"], a["src_b"], a["dst"], a["opcode"],
                          a["step_branch"], a["output_addrs"], words,
                          n_addr=p.n_addr)
    assert _k.launch_count() == before


def test_launch_counts_by_variant():
    before = (_k.launch_count("mega"), _k.launch_count("mega", "shared"),
              _k.launch_count(variant="device"))
    native.count_launch("mega", "shared")
    native.count_launch("logic", "device")
    assert (_k.launch_count("mega"), _k.launch_count("mega", "shared"),
            _k.launch_count(variant="device")) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    with pytest.raises(ValueError, match="unknown kernel"):
        native.count_launch("nope")


def test_build_is_keyed_on_source_hash(tmp_path, monkeypatch):
    """A built library is reused only for the identical sources and flags:
    its file name carries a hash over every ``csrc/*.cu`` and the flags,
    so a change to any one source asks for a new build (no nvcc is run
    here)."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert _k.build_dir() == tmp_path / "b"
    assert {s.name for s in native.sources()} >= {"logic_dsp.cu",
                                                   "xnor_gemm.cu"}
    name = native.library_name()
    (tmp_path / "b").mkdir()
    lib = tmp_path / "b" / name
    lib.write_bytes(b"")
    assert _k.build() == lib and _k.build_info["seconds"] == 0.0
    assert "sm_90a" in " ".join(native.NVCC_FLAGS)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in native.sources():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(native, "CSRC", csrc)
    assert native.library_name() == name
    (csrc / "xnor_gemm.cu").write_text("// changed\n")
    assert native.library_name() != name


@pytest.mark.parametrize("entry", ["xnor_gemm", "train_binary_mlp",
                                   "hidden_bits", "run_flow"])
def test_flow_and_xnor_entry_points_raise_without_cuda_unless_cpu(no_cuda,
                                                                  entry):
    a, b = _bits(6, 9, 40), _bits(7, 5, 40)
    mcfg = BinaryMLPConfig(n_features=8, hidden=(4,), n_classes=2)
    x, y = _bits(8, 64, 8).astype(np.float32), np.arange(64) % 2
    params = {k: v.numpy() for k, v in init_binary_mlp(mcfg).items()}
    clf = build_classifier(params, 2, x, CompileSpec(n_unit=8))
    cfg = FlowConfig(n_features=8, hidden=(4,), n_classes=2, n_samples=80,
                     train_steps=2, backends=("reference", "cuda"))
    calls = {
        "xnor_gemm": lambda **kw: xnor_gemm(a, b, **kw),
        "train_binary_mlp": lambda **kw: train_binary_mlp(
            mcfg, x, y, steps=2, batch=8, **kw),
        "hidden_bits": lambda **kw: clf.hidden_bits(x >= 0.5, "cuda", **kw),
        "run_flow": lambda **kw: run_flow(cfg, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    before = _k.launch_count()
    calls[entry](device="cpu")
    assert _k.launch_count() == before


@pytest.mark.parametrize("entry", ["quickstart", "transformer",
                                   "init_params", "init_decode_cache",
                                   "launch_serve"])
def test_quickstart_and_lm_entry_points_raise_without_cuda_unless_cpu(
        no_cuda, entry):
    cfg = get_config("qwen3-8b", smoke=True)
    calls = {
        "quickstart": lambda **kw: quickstart.run(**kw),
        "transformer": lambda **kw: Transformer(cfg, **kw),
        "init_params": lambda **kw: init_params(
            cfg, torch.Generator().manual_seed(0), **kw),
        "init_decode_cache": lambda **kw: init_decode_cache(cfg, 1, 8, **kw),
        "launch_serve": lambda **kw: launch_serve.main(
            ["--arch", "qwen3-8b", "--smoke", "--requests", "1",
             "--max-new", "1"] + [f"--{k}={v}" for k, v in kw.items()]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    before = _k.launch_count()
    calls[entry](device="cpu")
    assert _k.launch_count() == before


def test_xnor_wrapper_refuses_what_the_kernel_does_not_take():
    a = pack_pm1(torch.from_numpy(_bits(9, 9, 70)))
    b = pack_pm1(torch.from_numpy(_bits(10, 5, 70)))
    before = _k.launch_count("xnor")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _xk.xnor_cuda_call(a, b, 70)
    assert _k.launch_count("xnor") == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 32, 33, 70, 8192])
@pytest.mark.parametrize("n_unit,alloc", [(8, "direct"), (64, "liveness"),
                                          (256, "liveness")])
def test_logic_kernel_matches_plain_on_card(cuda, n_unit, alloc, batch):
    g, p = _prog(n_unit, n_unit=n_unit, n_gates=600, alloc=alloc)
    x = _bits(batch, batch, 8)
    before = _k.launch_count("logic")
    got = ops.logic_infer_bits(p, x, device=cuda)
    torch.cuda.synchronize()
    assert _k.launch_count("logic") == before + 1
    np.testing.assert_array_equal(got, ops.logic_infer_bits(
        p, x, device=cuda, use_ref=True))
    np.testing.assert_array_equal(got, execute_program_np(p, x))


def _mega(mode):
    rng = np.random.default_rng(4)
    if mode == "chain":
        graphs = [random_graph(rng, 8, 200, 6, locality=16),
                  LogicGraph(6, name="pass"),
                  random_graph(rng, 6, 200, 5, locality=16)]
        graphs[1].set_outputs([graphs[1].input_wire(i) for i in range(6)])
        perm = None
    else:
        graphs = [random_graph(rng, 8, 200, 3, locality=16),
                  random_graph(rng, 8, 150, 2, locality=16)]
        perm = np.array([4, 0, 3, 1, 2])
    progs = [compile_graph(gr, CompileSpec(n_unit=nu, optimize="none"))
             for gr, nu in zip(graphs, [8, 64, 16])]
    return build_megaprogram(progs, mode=mode, output_perm=perm)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chain", "parallel"])
def test_mega_kernel_matches_plain_on_card(cuda, mode):
    mega = _mega(mode)
    for batch in (1, 33, 70, 8192):
        x = _bits(batch, batch, 8)
        got = ops.mega_infer_bits(mega, x, device=cuda)
        np.testing.assert_array_equal(got, ops.mega_infer_bits(
            mega, x, device=cuda, use_ref=True))
        np.testing.assert_array_equal(got, execute_megaprogram_np(mega, x))


@pytest.mark.cuda
@pytest.mark.parametrize("two_barriers", [False, True])
@pytest.mark.parametrize("scratch", ["shared", "device"])
@pytest.mark.parametrize("mode", ["chain", "parallel"])
def test_scratch_variants_match_plain_on_card(cuda, mode, scratch,
                                              two_barriers):
    """Each scratch variant, with one barrier a step and with two, against
    the plain version and the numpy oracle at batches 1, 33 and 8192,
    counted under its variant."""
    mega = _mega(mode)
    m = ops.mega_arrays(mega, cuda)
    launch = ops.launch_records(
        mega.src_a, mega.src_b, mega.dst, mega.opcode, mega.step_branch,
        n_addr=mega.n_addr, trash=mega.step_trash, device=cuda,
        scratch=scratch, two_barriers=two_barriers)
    assert launch["plan"].scratch == scratch
    assert launch["plan"].one_barrier is not two_barriers
    for batch in (1, 33, 8192):
        x = _bits(batch, batch, 8)
        words = ops.pack_bits(torch.from_numpy(x).to(cuda))
        before = _k.launch_count("mega", scratch)
        got = _k.mega_cuda_call(
            launch["rec"], words, m["stage_table"], m["out_addrs"],
            m["out_rows"], n_addr=mega.n_addr, n_outputs=mega.n_outputs,
            chain=mode == "chain", handoff_rows=m["handoff_rows"],
            plan=launch["plan"])
        torch.cuda.synchronize()
        assert _k.launch_count("mega", scratch) == before + 1
        assert torch.equal(got, ops.mega_forward_words(mega, words,
                                                       use_ref=True))
        np.testing.assert_array_equal(ops.unpack_bits(got, batch).cpu()
                                      .numpy(),
                                      execute_megaprogram_np(mega, x))


@pytest.mark.cuda
@pytest.mark.parametrize("two_barriers", [False, True])
@pytest.mark.parametrize("scratch", ["shared", "device"])
def test_scratch_variants_k1_on_card(cuda, scratch, two_barriers):
    """K1 (mixed-opcode steps, liveness rows) in each variant."""
    g = random_graph(np.random.default_rng(9), 8, 600, 6, unary_frac=0.2,
                     locality=16)
    p = compile_graph(g, CompileSpec(n_unit=64, opcode_sort=False,
                                     optimize="none"))
    a = ops.program_arrays(p, cuda)
    launch = ops.launch_records(p.src_a, p.src_b, p.dst, p.opcode,
                                p.step_branch, n_addr=p.n_addr,
                                trash=p.trash_addr, device=cuda,
                                scratch=scratch, two_barriers=two_barriers)
    for batch in (1, 33, 8192):
        x = _bits(batch + 1, batch, 8)
        words = ops.pack_bits(torch.from_numpy(x).to(cuda))
        streams = (a["src_a"], a["src_b"], a["dst"], a["opcode"],
                   a["step_branch"], a["output_addrs"], words)
        before = _k.launch_count("logic", scratch)
        got = ops.forward_words(*streams, n_addr=p.n_addr, launch=launch)
        torch.cuda.synchronize()
        assert _k.launch_count("logic", scratch) == before + 1
        assert torch.equal(got, ops.forward_words(*streams, n_addr=p.n_addr,
                                                  use_ref=True))
        np.testing.assert_array_equal(
            ops.unpack_bits(got, batch).cpu().numpy(),
            execute_program_np(p, x))


@pytest.mark.cuda
def test_program_too_large_for_shared_memory_on_card(cuda):
    """A program past 2**16 rows takes the device-memory scratch by itself
    and matches the plain version and the numpy oracle."""
    g = random_graph(np.random.default_rng(2), 64, 66_000, 32,
                     unary_frac=0.2, locality=256)
    p = compile_graph(g, CompileSpec(n_unit=256, alloc="direct",
                                     optimize="none"))
    assert p.n_addr > _k.NARROW_ROWS
    assert ops.program_arrays(p, cuda)["plan"].scratch == "device"
    x = _bits(3, 100, 64)
    before = _k.launch_count("logic", "device")
    got = ops.logic_infer_bits(p, x, device=cuda)
    assert _k.launch_count("logic", "device") == before + 1
    np.testing.assert_array_equal(got, ops.logic_infer_bits(
        p, x, device=cuda, use_ref=True))
    np.testing.assert_array_equal(got, execute_program_np(p, x))


@pytest.mark.cuda
def test_engine_one_launch_per_wave_on_card(cuda):
    g, _ = _prog(5, n_gates=400)
    eng = LogicEngine(CompileSpec(n_unit=16, max_gates=150), capacity=64)
    x = _bits(5, 150, 8)
    before = _k.launch_count("mega")
    np.testing.assert_array_equal(eng.serve(g, x), g.evaluate(x))
    assert _k.launch_count("mega") - before == eng.stats()["invocations"]


@pytest.mark.cuda
@pytest.mark.parametrize("n_unit,batch", [(8, 1), (16, 70), (256, 8192)])
def test_phase_split_on_card(cuda, n_unit, batch):
    """phased_infer_bits on the card: one K1 launch a call, its words equal
    the fused path's and the oracle's, every phase timed; logic_infer_bits
    takes it while a PhaseTimer is active."""
    g, p = _prog(6, n_unit=n_unit, n_gates=600)
    x = _bits(6, batch, 8)
    before = _k.launch_count("logic")
    out, phases = ops.phased_infer_bits(p, x, device=cuda)
    assert _k.launch_count("logic") == before + 1
    assert set(phases) == set(PHASES) and all(
        v > 0 for v in phases.values())
    np.testing.assert_array_equal(out, ops.logic_infer_bits(p, x,
                                                            device=cuda))
    np.testing.assert_array_equal(out, execute_program_np(p, x))
    with PhaseTimer() as t:
        timed = ops.logic_infer_bits(p, x, device=cuda)
    np.testing.assert_array_equal(timed, out)
    assert t.samples[0]["meta"] == {"backend": "cuda", "n_unit": n_unit,
                                    "batch": batch}


@pytest.mark.cuda
def test_frontdoor_round_on_card(cuda):
    """Two tenants through a door on the card (its default device): every
    result equals the graph's bits, one K2 launch per engine wave, no K1
    launch, and the executor thread ran on the door's device."""
    g_a, _ = _prog(7, n_gates=300)
    g_b = random_graph(np.random.default_rng(8), 10, 200, 5, locality=16)
    rng = np.random.default_rng(9)

    async def go():
        door = FrontDoor(spec=CompileSpec(n_unit=16), capacity=256,
                         default_deadline_s=60.0)
        door.register("a", g_a)
        door.register("b", g_b)
        reqs = [(name, g, rng.integers(0, 2, (17 + 9 * i, g.n_inputs))
                 .astype(bool))
                for i, (name, g) in enumerate([("a", g_a), ("b", g_b)] * 4)]
        async with door:
            outs = await asyncio.gather(
                *(door.submit(name, x) for name, _, x in reqs))
        return door, reqs, outs

    k1, k2 = _k.launch_count("logic"), _k.launch_count("mega")
    door, reqs, outs = asyncio.run(asyncio.wait_for(go(), timeout=300))
    assert door.engine.device.type == "cuda"
    for (_, g, x), out in zip(reqs, outs):
        np.testing.assert_array_equal(out, g.evaluate(x))
    assert _k.launch_count("logic") == k1
    assert _k.launch_count("mega") - k2 == door.engine.invocations > 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (17, 4097, 33), (4097, 17, 100),
                                   (64, 64, 2304), (8192, 120, 400),
                                   (8193, 121, 400), (65, 129, 2304),
                                   (16384 + 63, 256 + 7, 2304),
                                   (100, 300, 416), (3, 5, 31)])
def test_xnor_kernel_matches_plain_on_card(cuda, m, n, k):
    a = torch.from_numpy(_bits(m, m, k)).to(cuda)
    b = torch.from_numpy(_bits(n + 1, n, k)).to(cuda)
    a[0] = 1                                   # words with bit 31 set
    before = _k.launch_count("xnor")
    got = xnor_gemm(a, b, device=cuda)
    torch.cuda.synchronize()
    assert _k.launch_count("xnor") == before + 1
    want = xnor_packed_ref(pack_pm1(a), pack_pm1(b), k)
    assert torch.equal(got, want)
    assert torch.equal(got, xnor_and_popc_ref(pack_pm1(a), pack_pm1(b), k))


@pytest.mark.cuda
def test_flow_on_card_is_exact_and_uses_the_kernels(cuda):
    """run_flow on the card: exact-mode parity, bit-identical backends, two
    K1 launches for the two-layer cuda chain, one K2 launch for the
    megakernel and one per engine wave."""
    cfg = FlowConfig(n_features=8, hidden=(6, 5), n_classes=3,
                     n_samples=700, train_steps=60,
                     spec=CompileSpec(n_unit=16))
    eng = LogicEngine(cfg.spec, capacity=256, device=cuda)
    _k.reset_launch_counts()
    report, _ = run_flow(cfg, device=cuda, engine=eng)
    assert report.parity and report.bit_identical
    assert _k.launch_count("logic") == 2
    assert _k.launch_count("mega") == 1 + eng.stats()["invocations"]


@pytest.mark.cuda
def test_conversion_takes_parameters_trained_on_card(cuda):
    """mlp_to_logic_network and build_classifier take train_binary_mlp's
    tensors on the card as they are, and convert them as their host
    copies."""
    cfg = BinaryMLPConfig(n_features=8, hidden=(6, 5), n_classes=3)
    x = _bits(4, 200, 8).astype(np.float32)
    y = np.random.default_rng(5).integers(0, 3, 200)
    params = train_binary_mlp(cfg, x, y, steps=5, device=cuda)
    assert params["w0"].device.type == "cuda"
    host = {k: v.cpu().numpy() for k, v in params.items()}
    net, want = mlp_to_logic_network(params, cfg, x), \
        mlp_to_logic_network(host, cfg, x)
    assert [g.fingerprint() for g in net.graphs] == \
        [g.fingerprint() for g in want.graphs]
    clf = build_classifier(params, 3, x, CompileSpec(n_unit=16))
    assert [c.graph.fingerprint() for c in clf.layers] == \
        [g.fingerprint() for g in want.graphs]


@pytest.mark.cuda
def test_quickstart_on_card(cuda):
    """The quickstart's circuit through K1: one launch, equal to the plain
    version, to direct evaluation and to the ground truth."""
    _k.reset_launch_counts()
    r = quickstart.run(device=cuda)
    assert _k.launch_count("logic") == 1
    plain = ops.logic_infer_bits(r["program"], r["x"], device=cuda,
                                 use_ref=True)
    np.testing.assert_array_equal(r["out"], plain)
    np.testing.assert_array_equal(r["out"], r["graph"].evaluate(r["x"]))


@pytest.mark.cuda
def test_logic_ffn_on_card_matches_cpu(cuda):
    """logic_ffn_apply on the card: one K1 launch, hidden bits equal to
    the CPU's plain executor, output within float32 rounding."""
    rng = np.random.default_rng(0)
    p = {"w_in": torch.from_numpy(0.5 * rng.normal(size=(48, 24))).float(),
         "b_in": torch.zeros(24),
         "w_out": torch.from_numpy(0.1 * rng.normal(size=(24, 48))).float()}
    calib = rng.integers(0, 2, (512, 48)).astype(np.uint8)
    prog = logic_mlp.ffn_to_program(p, calib, CompileSpec(n_unit=16))
    x = torch.from_numpy(rng.normal(size=(2, 80, 48))).float()
    pc = {k: v.to(cuda) for k, v in p.items()}
    _k.reset_launch_counts()
    h = logic_mlp.logic_hidden(prog, x.to(cuda))
    y = logic_mlp.logic_ffn_apply(prog, pc, x.to(cuda))
    assert _k.launch_count("logic") == 2
    assert torch.equal(h.cpu(), logic_mlp.logic_hidden(prog, x))
    torch.testing.assert_close(y.cpu(), logic_mlp.logic_ffn_apply(prog, p, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_prefill_decode_on_card_matches_forward_and_cpu(cuda):
    """The dense smoke model in float32 on the card (TF32 off): prefill
    plus decode against its own forward at 2e-3, and against the CPU's
    logits at 1e-4."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config("qwen3-8b", smoke=True)
        cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = Transformer(cfg, device=cuda)
        card.load_state_dict(cpu.state_dict())
        toks = torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
        full = card(toks.to(cuda))
        torch.testing.assert_close(full.cpu(), cpu(toks), rtol=1e-4,
                                   atol=1e-4)
        lp, cache = prefill(card, toks[:, :12].to(cuda), context=16)
        torch.testing.assert_close(lp, full[:, :12], rtol=2e-3, atol=2e-3)
        for t in range(12, 16):
            lg, cache = decode_step(card, toks[:, t:t + 1].to(cuda), cache)
            torch.testing.assert_close(lg[:, 0], full[:, t], rtol=2e-3,
                                       atol=2e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "grok-1-314b",
                                  "mamba2-370m", "recurrentgemma-2b",
                                  "internvl2-76b", "hubert-xlarge"])
def test_family_on_card_matches_cpu(cuda, arch):
    """Each family's smoke model in float32 on the card (TF32 off): the
    forward against the CPU's logits at 1e-4, and for the decoders
    prefill plus decode against the card's own forward at 2e-3."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch, smoke=True)
        cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = Transformer(cfg, device=cuda)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(1)
        if cfg.family == "audio":
            frames = torch.from_numpy(rng.normal(
                size=(2, 16, cfg.frontend_dim)).astype(np.float32))
            torch.testing.assert_close(card(frames=frames.to(cuda)).cpu(),
                                       cpu(frames=frames), rtol=1e-4,
                                       atol=1e-4)
            return
        S, P = 24, 19
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
        vis = {}
        if cfg.family == "vlm":
            vis["vision"] = torch.from_numpy(rng.normal(
                size=(2, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
        off = cfg.vision_tokens if vis else 0
        card_vis = {k: v.to(cuda) for k, v in vis.items()}
        full = card(toks.to(cuda), **card_vis)
        torch.testing.assert_close(full.cpu(), cpu(toks, **vis), rtol=1e-4,
                                   atol=1e-4)
        lp, cache = prefill(card, toks[:, :P].to(cuda), context=S + off,
                            **card_vis)
        torch.testing.assert_close(lp, full[:, :off + P], rtol=2e-3,
                                   atol=2e-3)
        for t in range(P, S):
            lg, cache = decode_step(card, toks[:, t:t + 1].to(cuda), cache)
            torch.testing.assert_close(lg[:, 0], full[:, off + t],
                                       rtol=2e-3, atol=2e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_sharded_engine_on_card(cuda):
    """The split path over two shards of one card: exact, one K2 launch a
    shard a wave, all on the shared variant."""
    g, _ = _prog(11, n_gates=300)
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=256,
                      devices=[cuda, cuda])
    x = _bits(12, 700, 8)
    k2 = _k.launch_count("mega", "shared")
    np.testing.assert_array_equal(eng.serve(g, x), g.evaluate(x))
    assert eng.stats()["n_devices"] == 2 and eng.stats()["sharded"]
    assert _k.launch_count("mega", "shared") - k2 == 2 * eng.invocations


@pytest.mark.cuda
def test_sharded_trainer_on_card_one_rank(cuda, tmp_path):
    """A one-rank NCCL group's (1, 1) mesh: the sharded step equals the
    one-device step (the same operations in the same order)."""
    import signal

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import TrainConfig, Trainer
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        cfg = get_config("qwen3-8b", smoke=True)
        tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         grad_accum=2, checkpoint_dir=str(tmp_path / "ck"))
        got = {}
        for name, mesh in (("one", None), ("mesh", make_host_mesh())):
            t = Trainer(cfg, tc, cuda, 4, 32, mesh=mesh)
            model, opt = t.init_state()
            model, _, m = t.train_step(model, opt, t.batch(0))
            params = model.params if mesh is not None else dict(
                model.named_parameters())
            got[name] = ({k: float(v) for k, v in m.items()},
                         {k: (v.to_local() if mesh is not None else v)
                          .detach().cpu() for k, v in params.items()})
        for k in ("loss", "grad_norm"):
            assert got["mesh"][0][k] == pytest.approx(got["one"][0][k],
                                                      rel=1e-6)
        for k, v in got["one"][1].items():
            torch.testing.assert_close(got["mesh"][1][k], v, rtol=0,
                                       atol=1e-6)
    finally:
        dist.destroy_process_group()
        for s, h in saved.items():
            signal.signal(s, h)


@pytest.mark.cuda
def test_dryrun_fake_cuda_and_cpu_count_alike(cuda):
    """The dry run's fake tensors take CUDA on a card's PyTorch (its
    default); one rank's counts equal those of the CPU's fake tensors,
    which the committed results and the CPU tests use.  The peak only
    differs by ``MemTracker`` rounding each CUDA storage up to the
    caching allocator's 512-byte blocks (a few KB here)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch import dryrun
    cfg = get_config("qwen3-8b", smoke=True)
    out = {}
    for dev in ("cuda", "cpu"):
        for cell in (ShapeCell("t", "train", 16, 8),
                     ShapeCell("d", "decode", 32, 8)):
            with dryrun.fake_group(4):
                mesh = init_device_mesh(dev, (1, 4),
                                        mesh_dim_names=("data", "model"))
                out[dev, cell.kind] = dryrun.measure_cell(cfg, cell, mesh,
                                                          device=dev)
    for kind in ("train", "decode"):
        for k in ("flops", "collectives", "bytes", "argument_bytes"):
            assert out["cuda", kind][k] == out["cpu", kind][k], (kind, k)
        cpu = out["cpu", kind]["peak_bytes"]
        assert cpu <= out["cuda", kind]["peak_bytes"] <= 1.01 * cpu, kind
