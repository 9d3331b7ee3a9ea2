"""Small copies of the benchmark for the CPU: the same cells, mixes,
drivers and metrics with the engine cut to 256 samples a wave.  In the
tiny copy the configurations are cut to a few dozen inputs too, so a cell
runs in a second; the wide copy keeps their published widths (the
control needs them: TF32 flips about one neuron-pattern bit in 25,000),
and reuses the checkout's synthesis cache where it has one."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LAYERS = {"fc1": (40, 12), "fc2": (12, 8)}


def make_root(where: Path, tiny: bool = True) -> Path:
    """A checkout holding ``BENCHMARK.json``, a small ``bench/`` and the
    port's sources (linked)."""
    shutil.copytree(BENCH, where / "bench", ignore=shutil.ignore_patterns(
        *((".cache",) if tiny else ()), "__pycache__"))
    (where / "src").symlink_to(ROOT / "src")
    shutil.copy(ROOT / "BENCHMARK.json", where / "BENCHMARK.json")
    for path in (where / "bench" / "configs").glob("*.json") if tiny else ():
        cfg = json.loads(path.read_text())
        for layer in cfg["layers"]:
            layer["fanin"], layer["neurons"] = TINY_LAYERS[layer["name"]]
        cfg.update(isf_patterns=64, spec={**cfg["spec"], "n_unit": 16})
        path.write_text(json.dumps(cfg))
    for path in (where / "bench" / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["capacity"] = 256
        if "request_samples" in mix:
            mix["request_samples"] = 256
        mix["warmup_waves"] = min(mix.get("warmup_waves", 2), 5)
        path.write_text(json.dumps(mix))
    return where


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench_root"))


@pytest.fixture(scope="session")
def wide_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench_wide"), tiny=False)


def runner_of(root: Path):
    """Run a cell of the copy at ``root`` on the CPU: ``(run, line)``."""
    import torch

    from benchkit import harness, layout
    cpu = torch.device("cpu")

    def go(cell: str, *, seed: int = 5, seconds: float = 1.0,
           traced: bool = False, hook=None):
        c = layout.resolve_cell(root, cell)
        run = harness.run_cell(root, c, seed=seed, seconds=seconds,
                               traced=traced, device=cpu,
                               t_process=time.perf_counter(), hook=hook)
        return run, harness.result_line(root, c, run, cpu)
    return go


@pytest.fixture(scope="session")
def run_tiny(tiny_root):
    return runner_of(tiny_root)


@pytest.fixture(scope="session")
def run_wide(wide_root):
    return runner_of(wide_root)
