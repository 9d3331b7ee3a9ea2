"""The benchmark runs the port alone: no JAX, no reference package."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}

PROBE = r"""
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root + "/bench", root + "/src"]
import torch
from benchkit import harness, layout
from pathlib import Path
for cell in json.load(open(root + "/BENCHMARK.json"))["workloads"]:
    c = layout.resolve_cell(Path(root), cell["name"])
    run = harness.run_cell(Path(root), c, seed=3, seconds=0.3, traced=True,
                           device=torch.device("cpu"),
                           t_process=time.perf_counter())
    harness.result_line(Path(root), c, run, torch.device("cpu"))
import reference.control
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_forbidden_module_is_loaded(tiny_root):
    """Every cell driven, traced, in a fresh process: the top-level names
    of what it loaded, compared whole (``repro_torch`` is not ``repro``)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE, str(tiny_root)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "benchkit" in loaded
    assert not loaded & FORBIDDEN


def test_harness_refuses_what_it_finds_loaded(monkeypatch):
    from benchkit import harness
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.loaded_forbidden() == ["repro"]


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    """Without CUDA the run exits non-zero and prints nothing; in a folder
    that holds only BENCHMARK.json and bench/ it does the same."""
    args = ["--workload", "fc1-bulk", "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), *args],
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, str(tmp_path / "bench/run.py"),
                        *args], capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
