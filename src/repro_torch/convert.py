"""Carry the reference package's state across into the port's types.

In this system the "weights" an engine computes with are the compiled
program streams; behind them are the binarized MLP's parameters.  Both
cross as plain data — numpy arrays, ints, strings and dicts, never
``repro`` objects — so this module imports nothing of the reference:

* :func:`program_from_reference` takes a reference
  ``LogicProgram.to_payload()`` ``(arrays, scalars)`` pair;
* :func:`graph_from_reference` takes a graph's ``n_inputs``, ``gates``,
  ``outputs`` and ``name``;
* :func:`artifact_from_reference` rebuilds a whole ``CompiledArtifact``
  (its programs, ``output_perm``, ``mode``, spec dict and graph);
* :func:`params_from_reference` validates the ``{"w{i}", "b{i}"}``
  float32 parameter dict of the reference's ``init_binary_mlp`` /
  ``train_binary_mlp``, which ``core.nullanet.layer_to_graph`` consumes
  layer by layer.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.compiler import CompiledArtifact
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.scheduler import LogicProgram
from repro_torch.core.spec import CompileSpec


def program_from_reference(arrays: dict, scalars: dict) -> LogicProgram:
    """The port's :class:`LogicProgram` from a reference payload (unknown
    or missing fields raise, as in ``LogicProgram.from_payload``)."""
    return LogicProgram.from_payload(
        {k: np.asarray(v) for k, v in arrays.items()}, dict(scalars))


def graph_from_reference(n_inputs: int, gates, outputs,
                         name: str = "ffcl") -> LogicGraph:
    """The port's :class:`LogicGraph` from a graph's plain data: ``gates``
    is a sequence (or ``(n, 3)`` array) of ``(opcode, a, b)`` wire
    triples."""
    gates = np.asarray(gates, dtype=np.int64).reshape(-1, 3)
    return LogicGraph(n_inputs=int(n_inputs),
                      gates=list(map(tuple, gates.tolist())),
                      outputs=[int(o) for o in outputs], name=str(name))


def artifact_from_reference(programs, output_perm, mode: str = "parallel",
                            *, spec: dict, graph: dict,
                            compile_s: float = 0.0) -> CompiledArtifact:
    """The port's :class:`CompiledArtifact` from a reference artifact's
    plain data.

    Args:
      programs: one ``(arrays, scalars)`` payload per program, in order.
      output_perm: the artifact's output permutation.
      mode: ``"parallel"`` or ``"chain"``.
      spec: the reference ``CompileSpec.to_dict()``.
      graph: ``{"n_inputs", "gates", "outputs", "name"}`` of the artifact's
        (post-optimization) graph.
    """
    if mode not in ("parallel", "chain"):
        raise ValueError(f"unknown artifact mode {mode!r}")
    progs = tuple(program_from_reference(a, s) for a, s in programs)
    if not progs:
        raise ValueError("an artifact needs at least one program")
    g = graph_from_reference(graph["n_inputs"], graph["gates"],
                             graph["outputs"], graph.get("name", "ffcl"))
    return CompiledArtifact(spec=CompileSpec.from_dict(dict(spec)), graph=g,
                            programs=progs,
                            output_perm=np.asarray(output_perm,
                                                   dtype=np.int64),
                            compile_s=float(compile_s), mode=mode)


def params_from_reference(params: dict) -> dict:
    """Validate and copy a binarized MLP's parameters: ``w{i}`` of shape
    ``(fin, fout)`` and ``b{i}`` of shape ``(fout,)`` for ``i = 0..L-1``,
    each layer's ``fin`` the previous layer's ``fout``.  Returns float32
    numpy arrays under the same keys."""
    out = {k: np.array(v, dtype=np.float32) for k, v in params.items()}
    n_layers = len(out) // 2
    want = {f"{p}{i}" for i in range(n_layers) for p in ("w", "b")}
    if len(out) % 2 or set(out) != want:
        raise ValueError(f"expected keys w0..w{n_layers - 1} and "
                         f"b0..b{n_layers - 1}, got {sorted(out)}")
    for i in range(n_layers):
        w, b = out[f"w{i}"], out[f"b{i}"]
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: w{i} {w.shape} and b{i} {b.shape} "
                             "are not (fin, fout) and (fout,)")
        if i and w.shape[0] != out[f"w{i - 1}"].shape[1]:
            raise ValueError(f"layer {i}: fanin {w.shape[0]} != previous "
                             f"layer's {out[f'w{i - 1}'].shape[1]} outputs")
        if not np.isfinite(w).all() or not np.isfinite(b).all():
            raise ValueError(f"layer {i}: non-finite parameters")
    return out
