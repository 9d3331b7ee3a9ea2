"""The served program: synthesized once a checkout, then loaded.

Synthesis (ISF -> espresso -> 2-input gates) takes about a minute of host
time for LeNet-5's fc1, so it must not sit in every run's set-up.  The
synthesized graphs and a ``repro_torch`` ``ArtifactStore`` live in
``bench/.cache/<config>/<key>/``; ``key`` hashes the configuration file
and every source of ``src/repro_torch``, so a change to either never runs
a stale program.  The first run of a checkout synthesizes, compiles and
fills the cache; every later run loads the graphs and serves the compiled
artifact from the store.

The program is imported inside these functions: ``run.py`` puts ``src``
on the path first.
"""
from __future__ import annotations

import hashlib
import os
import time
from pathlib import Path

import numpy as np

from benchkit.inputs import Layer

SOURCE_SUFFIXES = (".py", ".cu")


def source_hash(src: Path) -> str:
    """A hash over every source file of the package at ``src``."""
    h = hashlib.sha256()
    for path in sorted(p for p in src.rglob("*")
                       if p.suffix in SOURCE_SUFFIXES and p.is_file()):
        h.update(str(path.relative_to(src)).encode() + b"\0")
        h.update(path.read_bytes() + b"\0")
    return h.hexdigest()


def cache_dir(root: Path, config_name: str, config_path: Path) -> Path:
    h = hashlib.sha256(config_path.read_bytes())
    h.update(source_hash(root / "src" / "repro_torch").encode())
    return root / "bench" / ".cache" / config_name / h.hexdigest()[:16]


def _save_graphs(path: Path, graphs) -> None:
    arrays = {}
    for i, g in enumerate(graphs):
        arrays[f"gates{i}"] = np.asarray(g.gates, dtype=np.int32).reshape(-1, 3)
        arrays[f"outputs{i}"] = np.asarray(g.outputs, dtype=np.int64)
        arrays[f"n_inputs{i}"] = np.int64(g.n_inputs)
        arrays[f"name{i}"] = np.array(g.name)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.npz")
    np.savez(tmp, n=np.int64(len(graphs)), **arrays)
    os.replace(tmp, path)


def _load_graphs(path: Path) -> list:
    from repro_torch.core.gate_ir import LogicGraph
    with np.load(path) as z:
        return [LogicGraph(n_inputs=int(z[f"n_inputs{i}"]),
                           gates=list(map(tuple, z[f"gates{i}"].tolist())),
                           outputs=z[f"outputs{i}"].tolist(),
                           name=str(z[f"name{i}"]))
                for i in range(int(z["n"]))]


def graphs(layers: list[Layer], where: Path) -> tuple[list, dict]:
    """The configuration's synthesized graphs, one a layer, from the cache
    or, on a checkout's first run, from the port's ``layer_to_graph``."""
    path = where / "graphs.npz"
    t0 = time.perf_counter()
    if path.is_file():
        out = _load_graphs(path)
        return out, {"synthesized": False, "graphs_s": time.perf_counter() - t0}
    from repro_torch.core.nullanet import layer_to_graph
    out = [layer_to_graph(layer.patterns, layer.W, layer.b, mode="isf",
                          name=layer.name) for layer in layers]
    where.mkdir(parents=True, exist_ok=True)
    _save_graphs(path, out)
    return out, {"synthesized": True, "graphs_s": time.perf_counter() - t0}


def engine(config: dict, capacity: int, device, where: Path):
    """A ``LogicEngine`` on ``device`` with the configuration's spec,
    backed by the cache's artifact store."""
    from repro_torch.core.artifact_store import ArtifactStore
    from repro_torch.core.spec import CompileSpec
    from repro_torch.serve import LogicEngine
    return LogicEngine(CompileSpec(**config["spec"]), capacity=capacity,
                       device=device,
                       store=ArtifactStore(where / "store"))


def served_entries(engine) -> list:
    """The cache entries the engine has served (empty where the program's
    cache keeps them otherwise)."""
    entries = getattr(engine.cache, "_entries", None)
    return list(entries.values()) if isinstance(entries, dict) else []


def served_shape(engine, device) -> dict | None:
    """What one launch of the served program computes and moves: its
    gates, the words a launch covers, and the bytes of its inputs,
    outputs and index records, read from the program's artifact and its
    device arrays.  None where the engine serves more than one program
    or its structure cannot be read."""
    entries = served_entries(engine)
    if len(entries) != 1:
        return None
    from repro_torch.kernels.logic_dsp.ops import mega_arrays
    mega = entries[0].artifact.megaprogram()
    arrays = mega_arrays(mega, device)
    words = -(-engine.capacity // 32)
    return {"gates": int(sum(p.n_gates for p in mega.stages)),
            "words": words, "capacity": int(engine.capacity),
            "in_bytes": int(mega.n_inputs) * words * 4,
            "out_bytes": int(mega.n_outputs) * words * 4,
            "record_bytes": int(sum(arrays[k].numel() * arrays[k].element_size()
                                    for k in ("rec", "stage_table",
                                              "out_addrs", "out_rows"))),
            "steps": int(mega.total_steps)}
