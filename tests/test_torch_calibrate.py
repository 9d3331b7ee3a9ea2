"""The port's calibration phase path against the reference's, on the CPU.

``ops.phased_infer_bits`` splits one inference into the four phases of
``calibrate.PHASES``; ``logic_infer_bits`` routes through it while a
``PhaseTimer`` is active.  Its words must equal the fused path's, the
reference's phased path's and the numpy oracle's bit for bit.  The
restored probe collector runs on a torch device; the fit round-trips
through a store under the device's own record (``torch-cpu`` here,
``torch-cuda`` on the card), and an engine never loads another device's
fit or the reference's ``default`` one.  ``PAD_UNIT`` is 1 in the port,
since its kernel pads no lanes.
"""
import math
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core import calibrate as ref_calibrate
from repro.core.compiler import LogicCompiler as RefCompiler
from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.spec import CompileSpec as RefSpec
from repro.kernels.logic_dsp.ops import (
    phased_infer_bits as ref_phased_infer_bits)
from repro_torch.core import calibrate
from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.calibrate import (PHASES, PhaseTimer, collect_probes,
                                        fit_calibration,
                                        measure_program_phases, phase_terms)
from repro_torch.core.cost_model import CostModel, FfclStats
from repro_torch.core.gate_ir import LogicGraph, random_graph
from repro_torch.core.scheduler import compile_graph, execute_program_np
from repro_torch.core.spec import CompileSpec
from repro_torch.kernels.logic_dsp import ops
from repro_torch.serve import LogicEngine, ProgramCache
from repro_torch.tools import calibrate as calibrate_tool

ROOT = Path(__file__).resolve().parents[1]
MODEL = CostModel()


def _graphs(seed=0, n_in=12, n_gates=150, n_out=8):
    """The same seeded graph from each package."""
    kw = dict(locality=32)
    return (ref_random_graph(np.random.default_rng(seed), n_in, n_gates,
                             n_out, **kw),
            random_graph(np.random.default_rng(seed), n_in, n_gates, n_out,
                         **kw))


def _bits(seed, batch, n):
    return np.random.default_rng(seed).integers(0, 2, (batch, n)) \
        .astype(bool)


def _small_probe_graphs(n=2):
    return dict(list(calibrate.default_probe_graphs(quick=True).items())[:n])


# ---------------------------------------------------------------------------
# the phase path
# ---------------------------------------------------------------------------

def test_phase_timer_routes_logic_infer_bits():
    _, g = _graphs()
    prog = compile_graph(g, CompileSpec(n_unit=16, optimize="none"))
    bits = _bits(1, 64, g.n_inputs)
    assert calibrate.active_timer() is None
    fused = ops.logic_infer_bits(prog, bits, device="cpu")
    with PhaseTimer() as outer:
        with PhaseTimer() as t:
            timed = ops.logic_infer_bits(prog, bits, device="cpu")
            ref_timed = ops.logic_infer_bits(prog, bits, device="cpu",
                                             use_ref=True)
        assert calibrate.active_timer() is outer
    assert calibrate.active_timer() is None          # restored on exit
    assert not outer.samples
    np.testing.assert_array_equal(timed, fused)
    np.testing.assert_array_equal(ref_timed, fused)
    assert len(t.samples) == 2
    for sample in t.samples:
        assert set(sample["phases"]) == set(PHASES)
        assert all(math.isfinite(v) and v >= 0.0
                   for v in sample["phases"].values())
        assert sample["meta"] == {"backend": "ref", "n_unit": 16,
                                  "batch": 64}


@pytest.mark.parametrize("n_unit,n_gates,batch", [(8, 150, 1), (16, 200, 96),
                                                  (12, 260, 70),
                                                  (64, 400, 33)])
def test_phased_infer_bits_bit_identical_to_fused_and_reference(
        n_unit, n_gates, batch):
    ref_g, g = _graphs(seed=n_unit, n_gates=n_gates)
    spec = dict(n_unit=n_unit, optimize="none")
    prog = compile_graph(g, CompileSpec(**spec))
    ref_prog = RefCompiler().compile(ref_g, RefSpec(**spec)).program
    bits = _bits(n_unit, batch, g.n_inputs)
    out, phases = ops.phased_infer_bits(prog, bits, device="cpu")
    ref_out, ref_phases = ref_phased_infer_bits(ref_prog, bits)
    assert set(phases) == set(ref_phases) == set(PHASES)
    assert out.dtype == np.bool_ and out.shape == ref_out.shape
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(
        out, ops.logic_infer_bits(prog, bits, device="cpu"))
    np.testing.assert_array_equal(out, execute_program_np(prog, bits))


def test_phased_infer_bits_gateless_program():
    g = LogicGraph(6, name="pass")
    g.set_outputs([g.input_wire(i) for i in (5, 3, 1)] + [0, 1])
    prog = compile_graph(g, CompileSpec(n_unit=8, optimize="none"))
    assert prog.n_steps == 0
    bits = _bits(3, 40, 6)
    out, _ = ops.phased_infer_bits(prog, bits, device="cpu")
    np.testing.assert_array_equal(out, g.evaluate(bits))


def test_phase_setup_reuploads_records_built_once(monkeypatch):
    """``setup`` uploads host arrays memoized on the program: the kernel's
    launch records (lane order, one-barrier proof) are built once per
    program, never per call."""
    _, g = _graphs(seed=4)
    prog = compile_graph(g, CompileSpec(n_unit=16, optimize="none"))
    built = []
    real = ops.launch_records

    def counted(*a, **kw):
        built.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "launch_records", counted)
    first = ops._phase_host_arrays(prog, plain=False)
    assert ops._phase_host_arrays(prog, plain=False) is first
    assert built == ["cpu"]
    assert first["rec"].device.type == "cpu"
    assert first["rec"].shape[:2] == (prog.n_steps, prog.n_unit)
    assert set(first) == {"rec", "plan", "output_addrs"}
    plain = ops._phase_host_arrays(prog, plain=True)
    assert set(plain) == {"src_a", "src_b", "dst", "opcode",
                          "step_branch", "output_addrs"}
    assert built == ["cpu"]
    for _ in range(3):
        ops.phased_infer_bits(prog, _bits(5, 40, g.n_inputs), device="cpu")
    assert ops._phase_host_arrays(prog, plain=True) is plain


# ---------------------------------------------------------------------------
# probes, fit and the calibration record
# ---------------------------------------------------------------------------

def test_collect_probes_two_graphs_three_units():
    graphs = _small_probe_graphs(2)
    units = (8, 16, 32)
    probes = collect_probes(graphs, units, n_input_vectors=128, reps=2,
                            device="cpu")
    assert [(p.label, p.n_unit) for p in probes] == \
        [(label, u) for label in graphs for u in units]
    ref_graphs = dict(list(ref_calibrate.default_probe_graphs(
        quick=True).items())[:2])
    for p in probes:
        g = graphs[p.label]
        assert g.fingerprint() == ref_graphs[p.label].fingerprint()
        assert p.n_gates == g.n_gates and p.n_input_vectors == 128
        assert set(p.measured) == set(PHASES)
        assert all(math.isfinite(v) and v >= 0.0
                   for v in p.measured.values())
        # at multiples of 8 the port's regressors equal the reference's
        want = ref_calibrate.phase_terms(
            ref_calibrate.CostModel(),
            ref_calibrate.FfclStats.from_graph(ref_graphs[p.label]),
            p.n_unit, 128)
        assert p.terms == want
    cal = fit_calibration(probes)
    for f in cal.fits.values():
        assert all(math.isfinite(c) and c >= 0.0 for c in (*f.coefs,
                                                            f.offset))
    best = measure_program_phases(
        compile_graph(graphs[probes[0].label],
                      CompileSpec(n_unit=8, optimize="none")), 64, reps=2,
        device="cpu")
    assert set(best) == set(PHASES)


def test_pad_unit_is_one_in_the_port():
    """The kernel width regressor takes n_unit as it is (the reference
    pads it to a multiple of 8, its TPU kernel's sublane padding)."""
    assert calibrate.PAD_UNIT == 1 and ref_calibrate.PAD_UNIT == 8
    ref_g, g = _graphs(seed=6, n_gates=300)
    stats = FfclStats.from_graph(g)
    ref_stats = ref_calibrate.FfclStats.from_graph(ref_g)
    for u in (5, 12, 13, 16):
        terms = phase_terms(MODEL, stats, u, 256)
        ref_terms = ref_calibrate.phase_terms(ref_calibrate.CostModel(),
                                              ref_stats, u, 256)
        nsk = terms["kernel"][0]
        assert terms["kernel"] == (nsk, nsk * u)
        assert ref_terms["kernel"] == (nsk, nsk * (-(-u // 8) * 8))
        assert {p: terms[p] for p in ("pack", "setup", "unpack")} == \
            {p: ref_terms[p] for p in ("pack", "setup", "unpack")}


def test_calibration_names_by_device():
    assert ops.CALIBRATION_NAMES == {"cuda": "torch-cuda",
                                     "cpu": "torch-cpu"}
    assert ops.calibration_name("cpu") == "torch-cpu"


def _fit(tag: str):
    probes = collect_probes(_small_probe_graphs(2), (8, 16, 32),
                            n_input_vectors=64, reps=1, device="cpu")
    return fit_calibration(probes, meta={"tag": tag})


def test_fit_round_trips_through_store_under_torch_cpu(tmp_path):
    cal = _fit("cpu")
    store = ArtifactStore(tmp_path / "store")
    path = store.save_calibration(cal, name=ops.calibration_name("cpu"))
    assert path.name == "torch-cpu.json"
    before = calibrate.fit_count()
    loaded = ArtifactStore(tmp_path / "store").load_calibration("torch-cpu")
    assert loaded.to_dict() == cal.to_dict()
    cache = ProgramCache(store=ArtifactStore(tmp_path / "store"),
                         device="cpu")
    assert cache.compiler.calibration.to_dict() == cal.to_dict()
    eng = LogicEngine(CompileSpec(n_unit="auto", objective="wallclock"),
                      capacity=64, device="cpu",
                      store=ArtifactStore(tmp_path / "store"))
    assert eng.cache.compiler.calibration.meta == {"tag": "cpu"}
    _, g = _graphs(seed=8, n_gates=300)
    x = _bits(8, 40, g.n_inputs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no fallback to cycles
        np.testing.assert_array_equal(eng.serve(g, x), g.evaluate(x))
    assert calibrate.fit_count() == before, "loading must never re-fit"


def test_cpu_engine_never_loads_cuda_or_default_record(tmp_path):
    store = ArtifactStore(tmp_path / "store")
    store.save_calibration(_fit("cuda"), name="torch-cuda")
    store.save_calibration(_fit("default"))             # name "default"
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=64, device="cpu",
                      store=ArtifactStore(tmp_path / "store"))
    assert eng.cache.compiler.calibration is None
    spec = CompileSpec(n_unit="auto", objective="wallclock")
    _, g = _graphs(seed=9, n_gates=200)
    with pytest.warns(RuntimeWarning, match="falling back"):
        ProgramCache(store=ArtifactStore(tmp_path / "store"),
                     device="cpu").get(g, spec)
    store.save_calibration(_fit("cpu"), name="torch-cpu")
    eng = LogicEngine(CompileSpec(n_unit=16), capacity=64, device="cpu",
                      store=ArtifactStore(tmp_path / "store"))
    assert eng.cache.compiler.calibration.meta == {"tag": "cpu"}


def test_shared_cache_carries_its_device_and_refuses_another(tmp_path,
                                                           monkeypatch):
    """A store-backed cache built for CUDA holds the ``torch-cuda`` fit: a
    CPU engine refuses to share it, a CPU-built cache is shared by CPU
    engines, and a cache with neither store nor device is any device's."""
    store = ArtifactStore(tmp_path / "store")
    store.save_calibration(_fit("cuda"), name="torch-cuda")
    store.save_calibration(_fit("cpu"), name="torch-cpu")
    # a card host as far as device resolution goes (no tensor is made)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.current_device", lambda: 0)
    cuda_cache = ProgramCache(store=ArtifactStore(tmp_path / "store"))
    assert str(cuda_cache.device) == "cuda:0"
    assert cuda_cache.compiler.calibration.meta == {"tag": "cuda"}
    with pytest.raises(ValueError, match="built for cuda:0"):
        LogicEngine(CompileSpec(n_unit=16), capacity=64, device="cpu",
                    cache=cuda_cache)
    cpu_cache = ProgramCache(store=ArtifactStore(tmp_path / "store"),
                             device="cpu")
    assert cpu_cache.compiler.calibration.meta == {"tag": "cpu"}
    engines = [LogicEngine(CompileSpec(n_unit=16), capacity=64,
                           device="cpu", cache=cpu_cache) for _ in range(2)]
    assert all(e.cache is cpu_cache for e in engines)
    assert ProgramCache().device is None
    LogicEngine(CompileSpec(n_unit=16), capacity=64, device="cpu",
                cache=ProgramCache())


def test_calibrate_tool_fits_publishes_and_verifies_on_cpu(tmp_path,
                                                           capsys):
    store_dir = tmp_path / "store"
    assert calibrate_tool.main(["--store", str(store_dir), "--device",
                                "cpu", "--reps", "1", "--batch", "64",
                                "--verify"]) == 0
    out = capsys.readouterr().out
    assert "zero re-fits" in out and "torch-cpu.json" in out
    assert sorted(p.name for p in (store_dir / "calibration").iterdir()) \
        == ["torch-cpu.json"]
    cal = ArtifactStore(store_dir).load_calibration("torch-cpu")
    assert cal.meta["device"] == "cpu" and cal.meta["n_probes"] == 15


def test_calibrate_tool_runs_as_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.calibrate", "--help"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--name" not in proc.stdout
