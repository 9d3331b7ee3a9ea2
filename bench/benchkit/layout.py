"""Find every piece of a cell by its name, so that later cells are files.

``BENCHMARK.json`` names a cell's configuration and traffic mix; the rest
is found on disk under the benchmark's folder:

- ``configs[].file``: the configuration (``bench/configs/<name>.json``);
- ``bench/mixes/<traffic>.json``: the mix, whose ``driver`` names
  ``bench/drivers/<driver>.py``;
- ``bench/metrics/<metric>.py``: one reader a metric, end-to-end or
  per-layer, with a ``read(run)`` that returns a number or None.

Adding a configuration, a mix or a metric is adding its file and its
entry in ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = "bench"


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config_path: Path
    config: dict
    mix_name: str
    mix: dict
    chips: int
    end_to_end: tuple      # BENCHMARK.json metric entries this cell reports
    per_layer: tuple


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or cell in cells


def resolve_cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[work["config"]]
    config_path = root / entry["file"]
    with open(config_path) as f:
        config = json.load(f)
    mix_path = root / BENCH_DIR / "mixes" / f"{work['traffic']}.json"
    with open(mix_path) as f:
        mix = json.load(f)
    return Cell(name=name, config_name=entry["name"],
                config_path=config_path, config=config,
                mix_name=work["traffic"], mix=mix, chips=int(work["chips"]),
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if _reports(m, name)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if _reports(m, name)))


def load_module(path: Path, module_name: str):
    """Import one file of the benchmark as ``module_name`` (its file name
    may hold dots, as a metric's does)."""
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module


def _module_name(kind: str, name: str, path: Path) -> str:
    """A module name of its own for each file (a test may load the same
    metric from two copies of the benchmark)."""
    tag = hashlib.sha256(str(path.resolve()).encode()).hexdigest()[:8]
    return f"bench_{kind}_{tag}_" + "".join(
        c if c.isalnum() else "_" for c in name)


def driver(root: Path, mix: dict):
    """The driver module a mix names."""
    name = mix["driver"]
    path = root / BENCH_DIR / "drivers" / f"{name}.py"
    return load_module(path, _module_name("driver", name, path))


def metric_reader(root: Path, name: str):
    """The ``read(run)`` of the metric ``name``."""
    path = root / BENCH_DIR / "metrics" / f"{name}.py"
    return load_module(path, _module_name("metric", name, path)).read
