"""Device routing of the port's entry points, and the CUDA kernels on the
card.

The entry points run on CUDA unless the caller names the CPU, and raise
when no CUDA device is present; they never fall back to the CPU quietly.
The CUDA kernel wrappers refuse CPU tensors.  Tests that need the card are
marked ``cuda`` and skip without one (decided inside the test, never at
import).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.gate_ir import LogicGraph, random_graph
from repro_torch.core.scheduler import (build_megaprogram, compile_graph,
                                        execute_megaprogram_np,
                                        execute_program_np)
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp import kernel as _k
from repro_torch.kernels.logic_dsp import ops
from repro_torch.serve import LogicEngine


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


@pytest.mark.parametrize("entry", ["logic_infer_bits", "mega_infer_bits",
                                   "engine", "program_arrays"])
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    g, p = _prog()
    mega = build_megaprogram([p], mode="chain")
    x = _bits(1, 40, 8)
    calls = {
        "logic_infer_bits": lambda **kw: ops.logic_infer_bits(p, x, **kw),
        "mega_infer_bits": lambda **kw: ops.mega_infer_bits(mega, x, **kw),
        "engine": lambda **kw: LogicEngine(CompileSpec(n_unit=8),
                                           capacity=64, **kw).serve(g, x),
        "program_arrays": lambda **kw: ops.program_arrays(p, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    out = calls[entry](device="cpu")
    if entry != "program_arrays":
        np.testing.assert_array_equal(out, g.evaluate(x))


def test_kernel_wrappers_refuse_cpu_tensors():
    _, p = _prog()
    arrs = ops.program_arrays(p, "cpu")
    words = ops.pack_bits(torch.from_numpy(_bits(2, 40, 8)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _k.logic_cuda_call(arrs["src_a"], arrs["src_b"], arrs["dst"],
                           arrs["opcode"], arrs["step_branch"], words,
                           arrs["output_addrs"], n_addr=p.n_addr)
    mega = build_megaprogram([p], mode="parallel")
    m = ops.mega_arrays(mega, "cpu")
    before = _k.launch_count()
    with pytest.raises(ValueError, match="CUDA tensor"):
        _k.mega_cuda_call(m["src_a"], m["src_b"], m["dst"], m["opcode"],
                          m["step_branch"], words, m["stage_table"],
                          m["out_addrs"], m["out_rows"], n_addr=mega.n_addr,
                          n_outputs=mega.n_outputs, chain=False,
                          handoff_rows=0)
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
    results would not fit shared memory."""
    assert _k.cols_per_block(n_unit) == want


def test_cols_per_block_refuses_oversized_unit():
    with pytest.raises(ValueError, match="shared memory"):
        _k.cols_per_block(60_000)


def test_build_is_keyed_on_source_hash(tmp_path, monkeypatch):
    """A built library is reused only for the identical source and flags:
    the file name carries their hash (no nvcc is run here)."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert _k.build_dir() == tmp_path / "b"
    import hashlib
    digest = hashlib.sha256(_k.SOURCE.read_bytes() +
                            " ".join(_k.NVCC_FLAGS).encode()).hexdigest()[:16]
    (tmp_path / "b").mkdir()
    lib = tmp_path / "b" / f"liblogic_dsp_{digest}.so"
    lib.write_bytes(b"")
    assert _k.build() == lib and _k.build_info["seconds"] == 0.0
    assert "sm_90a" in " ".join(_k.NVCC_FLAGS)


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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chain", "parallel"])
def test_mega_kernel_matches_plain_on_card(cuda, mode):
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
    mega = build_megaprogram(progs, mode=mode, output_perm=perm)
    for batch in (1, 33, 70, 8192):
        x = _bits(batch, batch, 8)
        got = ops.mega_infer_bits(mega, x, device=cuda)
        np.testing.assert_array_equal(got, ops.mega_infer_bits(
            mega, x, device=cuda, use_ref=True))
        np.testing.assert_array_equal(got, execute_megaprogram_np(mega, x))


@pytest.mark.cuda
def test_engine_one_launch_per_wave_on_card(cuda):
    g, _ = _prog(5, n_gates=400)
    eng = LogicEngine(CompileSpec(n_unit=16, max_gates=150), capacity=64)
    x = _bits(5, 150, 8)
    before = _k.launch_count("mega")
    np.testing.assert_array_equal(eng.serve(g, x), g.evaluate(x))
    assert _k.launch_count("mega") - before == eng.stats()["invocations"]
