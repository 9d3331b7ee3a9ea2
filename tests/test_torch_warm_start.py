"""Store-backed serving in the port: precompile, warm start, quarantine.

``repro_torch.tools.precompile`` fills an ``ArtifactStore`` with the
entries a ``ProgramCache`` would compile; a fresh process then serves
from it with zero compiles (``repro_torch.examples.warm_start``).  The
store format is the reference's (a verbatim copy), so the port's tool
must address the same keys as ``tools/precompile.py``.  A corrupt entry is
quarantined and recompiled, never served.  Everything here runs on the
CPU (``device="cpu"``); results are words, held bit-exact against the
graph and the reference engine.
"""
import asyncio
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.gate_ir import LogicGraph as RefGraph
from repro.core.spec import CompileSpec as RefSpec
from repro.serve import LogicEngine as RefEngine
from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.spec import CompileSpec
from repro_torch.examples import warm_start
from repro_torch.serve import FrontDoor, LogicEngine
from repro_torch.tools import precompile

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = ["--seed", "3", "--count", "2", "--inputs", "12", "--gates",
            "300", "--outputs", "6", "--locality", "32", "--n-unit", "16"]


def _ref_tool():
    """The reference's ``tools/precompile.py`` (a script, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "ref_precompile_tool", ROOT / "tools" / "precompile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    return env


def _graphs():
    return precompile.build_graphs(3, 2, 12, 300, 6, 32)


def _ref_bits(graph, bits, spec_kw):
    ref_g = RefGraph(n_inputs=graph.n_inputs, gates=list(graph.gates),
                     outputs=list(graph.outputs), name=graph.name)
    return RefEngine(RefSpec(**spec_kw), capacity=128).serve(ref_g, bits)


def test_precompile_then_fresh_process_serves_with_zero_compiles(tmp_path,
                                                                 capsys):
    store_dir = str(tmp_path / "store")
    assert precompile.main(["--store", store_dir, "--jobs", "0", "--verify",
                            "--device", "cpu", *WORKLOAD]) == 0
    assert "[verified on cpu]" in capsys.readouterr().out
    assert ArtifactStore(store_dir).stats()["entries"] == 2
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.warm_start", "--store",
         store_dir, "--device", "cpu", *WORKLOAD], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "warm node: 0 compiles, 2 store hits" in proc.stdout


@pytest.mark.parametrize("max_gates", [None, 60])
def test_precompile_addresses_the_reference_tools_keys(tmp_path, max_gates):
    ref_tool = _ref_tool()
    kw = dict(n_unit=16, max_gates=max_gates)
    ref_graphs = ref_tool.build_graphs(3, 2, 12, 300, 6, 32)
    graphs = _graphs()
    assert [g.fingerprint() for g in graphs] == \
        [g.fingerprint() for g in ref_graphs]
    from repro.core.artifact_store import ArtifactStore as RefStore
    ref_store, store = RefStore(tmp_path / "ref"), ArtifactStore(
        tmp_path / "port")
    for ref_g, g in zip(ref_graphs, graphs):
        ref_key, _, _ = ref_tool.precompile_graph(ref_store, ref_g,
                                                  RefSpec(**kw), None)
        key, art, _ = precompile.precompile_graph(store, g,
                                                  CompileSpec(**kw), None)
        assert key == ref_key and art is not None
        assert len(art.programs) > 1 if max_gates else len(art.programs) == 1
        precompile.verify_entry(store, g, CompileSpec(**kw),
                                np.random.default_rng(0), device="cpu")
        # a second run finds the entry published
        assert precompile.precompile_graph(store, g, CompileSpec(**kw),
                                           None)[1] is None
    assert sorted(store.keys()) == sorted(ref_store.keys())


def test_store_backed_engine_cold_then_warm(tmp_path):
    spec_kw = dict(n_unit=16, max_gates=150)
    graphs = _graphs()
    rng = np.random.default_rng(5)
    reqs = [rng.integers(0, 2, (70, g.n_inputs)).astype(bool)
            for g in graphs]
    cold = LogicEngine(CompileSpec(**spec_kw), capacity=64, device="cpu",
                       store=ArtifactStore(tmp_path / "store"))
    cold_out = [cold.serve(g, x) for g, x in zip(graphs, reqs)]
    cs = cold.cache.stats()
    assert cs["compiles"] == 2 and cs["store_saves"] == 2
    warm = LogicEngine(CompileSpec(**spec_kw), capacity=64, device="cpu",
                       store=ArtifactStore(tmp_path / "store"))
    for g, x, out in zip(graphs, reqs, cold_out):
        got = warm.serve(g, x)
        np.testing.assert_array_equal(got, out)
        np.testing.assert_array_equal(got, g.evaluate(x))
        np.testing.assert_array_equal(got, _ref_bits(g, x, spec_kw))
    ws = warm.cache.stats()
    assert ws["compiles"] == 0 and ws["store_hits"] == 2
    assert ws["store_failures"] == 0


def test_frontdoor_warm_starts_from_store(tmp_path):
    store_dir = str(tmp_path / "store")
    assert precompile.main(["--store", store_dir, "--jobs", "0", "--device",
                            "cpu", *WORKLOAD]) == 0
    graphs = _graphs()
    rng = np.random.default_rng(6)

    async def go():
        door = FrontDoor(spec=CompileSpec(n_unit=16), capacity=128,
                         store=ArtifactStore(store_dir),
                         default_deadline_s=30.0, device="cpu")
        for i, g in enumerate(graphs):
            door.register(f"t{i}", g)
        served = []
        async with door:
            for i, g in enumerate(graphs):
                x = rng.integers(0, 2, (33, g.n_inputs)).astype(bool)
                served.append((g, x, await door.submit(f"t{i}", x)))
        return door, served

    door, served = asyncio.run(asyncio.wait_for(go(), timeout=90))
    for g, x, out in served:
        np.testing.assert_array_equal(out, g.evaluate(x))
    st = door.metrics()["engine"]
    assert st["cache_compiles"] == 0 and st["cache_store_hits"] == 2


def test_corrupt_entry_is_quarantined_and_recompiled(tmp_path):
    spec = CompileSpec(n_unit=16)
    g = _graphs()[0]
    LogicEngine(spec, capacity=64, device="cpu",
                store=ArtifactStore(tmp_path)).serve(
        g, np.zeros((1, g.n_inputs), bool))
    store = ArtifactStore(tmp_path)
    (key,) = store.keys()
    npz = store.path_of(key) / "arrays.npz"
    npz.write_bytes(b"not an npz at all")

    fresh = ArtifactStore(tmp_path)
    eng = LogicEngine(spec, capacity=64, device="cpu", store=fresh)
    x = np.random.default_rng(7).integers(0, 2, (40, g.n_inputs)) \
        .astype(bool)
    out = eng.serve(g, x)
    np.testing.assert_array_equal(out, g.evaluate(x))
    st = eng.cache.stats()
    assert st["compiles"] == 1 and st["store_failures"] == 1
    assert st["store_hits"] == 0 and st["store_saves"] == 1
    assert fresh.integrity_failures == 1 and fresh.quarantined == 1
    assert [p.name.split(".")[0] for p in
            (tmp_path / "quarantine").iterdir()] == [key]
    # the write-through after the fallback republished a valid entry
    warm = LogicEngine(spec, capacity=64, device="cpu",
                       store=ArtifactStore(tmp_path))
    np.testing.assert_array_equal(warm.serve(g, x), out)
    assert warm.cache.stats()["compiles"] == 0


def test_warm_start_example_uses_the_precompile_tools_generator():
    assert warm_start.build_graphs is precompile.build_graphs
    ref = _ref_tool().build_graphs(0, 2, 16, 200, 8, 64)
    assert [g.fingerprint() for g in precompile.build_graphs(
        0, 2, 16, 200, 8, 64)] == [g.fingerprint() for g in ref]


def test_warm_start_example_self_contained_on_cpu(capsys):
    assert warm_start.main(["--device", "cpu", "--gates", "300"]) == 0
    out = capsys.readouterr().out
    assert "cold node: 1 compiles" in out
    assert "warm node: 0 compiles, 1 store hits" in out


@pytest.mark.parametrize("example,args", [
    ("serve_logic", []), ("serve_frontdoor", ["--quick"])])
def test_serving_examples_run_on_cpu(example, args):
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{example}", *args,
         "--device", "cpu"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bit-exact" in proc.stdout or "no hangs" in proc.stdout
