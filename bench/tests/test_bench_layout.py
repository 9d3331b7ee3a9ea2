"""Every piece of a cell is found by its name, and a new one is a file."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchkit import layout

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_config_mix_driver_and_metrics(cell):
    c = layout.resolve_cell(ROOT, cell)
    assert c.config["name"] == c.config_name
    assert hasattr(layout.driver(ROOT, c.mix), "run")
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    assert "setup_s" in names
    for name in names:
        assert callable(layout.metric_reader(ROOT, name))


def test_benchmark_keeps_to_its_contract():
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    assert set(BENCHMARK) == top
    assert BENCHMARK["paths"] == ["bench"]
    configs = {c["name"] for c in BENCHMARK["configs"]}
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == configs
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for w in BENCHMARK["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        reported = [m for m in BENCHMARK["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    for m in BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved), m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in BENCHMARK["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []


def test_new_config_mix_and_metric_are_found_as_files(tmp_path):
    """A later change adds a cell with files and entries alone."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/lenet5-fc1.json").read_text())
    cfg.update(name="lenet5-fc2", layers=[
        {"name": "fc2", "fanin": 400, "neurons": 84}])
    (tmp_path / "bench/configs/lenet5-fc2.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "bench/mixes/bulk.json").read_text())
    mix["outstanding"] = 2
    (tmp_path / "bench/mixes/pairs.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/waves.new.py").write_text(
        "def read(run):\n    return run.engine.get('invocations')\n")
    bench["configs"].append({"name": "lenet5-fc2", "source": "x",
                             "file": "bench/configs/lenet5-fc2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "fc2-pairs", "config": "lenet5-fc2",
                               "traffic": "pairs", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "waves.new", "unit": "waves",
                               "better": "higher", "source":
                               "program_counter", "layer": "engine",
                               "moves": "samples_per_s",
                               "workloads": ["fc2-pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = layout.resolve_cell(tmp_path, "fc2-pairs")
    assert c.config["layers"][0]["neurons"] == 84
    assert c.mix["outstanding"] == 2
    assert [m["name"] for m in c.per_layer] == ["waves.new"]
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]
    read = layout.metric_reader(tmp_path, "waves.new")

    class Run:
        engine = {"invocations": 7}
    assert read(Run()) == 7
    assert layout.driver(tmp_path, c.mix).__file__.endswith("closed.py")
