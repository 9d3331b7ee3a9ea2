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
  layer by layer;
* :func:`transformer_params_from_reference` turns a transformer's
  parameter tree of any family (``models/transformer.init_params``'s, as
  numpy: the layers stacked in ``blocks``, the hybrid's ``groups`` and
  ``tail``, or unrolled ``layers``; with ``cfg.logic_mlp`` the dense
  blocks carry the logic FFN's ``w_in``, ``b_in`` and ``w_out``) into the
  state dict of the port's ``Transformer``;
* :func:`adamw_state_from_reference` turns the reference's ``AdamWState``
  (``step``, and ``mu`` / ``nu`` trees like the parameters) into the
  port's, keyed by the same state-dict names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compiler import CompiledArtifact
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.scheduler import LogicProgram
from repro_torch.core.spec import CompileSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (block_param_spec,
                                            hybrid_grouping, layer_kinds,
                                            param_spec)
from repro_torch.optim.adamw import AdamWState, resolve_moment_dtype


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


def reference_layout(cfg: ModelConfig) -> str:
    """How the reference's tree stores the layers
    (``models/transformer.param_spec``): ``"blocks"`` (a homogeneous
    stack, every leaf with a leading layer axis), ``"groups"`` (the
    hybrid's pattern stacks plus an unstacked ``tail``) or ``"layers"``
    (one dict a layer)."""
    kinds = layer_kinds(cfg)
    if cfg.scan_layers and len(set(kinds)) == 1:
        return "blocks"
    if cfg.scan_layers and cfg.family == "hybrid" and cfg.block_pattern:
        return "groups"
    return "layers"


def transformer_params_from_reference(params: dict,
                                      cfg: ModelConfig) -> dict:
    """The port's ``Transformer`` state dict from the reference's
    parameter tree, as arrays: the top-level leaves (``embed``,
    ``final_norm``, ``lm_head`` unless tied; ``frontend_proj`` and
    ``head`` for audio) and the layers in the layout
    :func:`reference_layout` names.  Layer i becomes ``blocks.{i}.{name}``:
    from ``blocks[name][i]``; from ``groups[j][name][g]`` for i = g *
    len(block_pattern) + j, the ``tail`` after the groups; or from
    ``layers[i]``.  Every leaf must have the shape the port's parameter
    spec gives its layer's kind (MoE experts stay stacked (E, ...); the
    logic FFN's with ``cfg.logic_mlp``)."""
    top = {k: shape for k, (_, shape) in param_spec(cfg).items()}
    layout = reference_layout(cfg)
    specs = [{k: shape for k, (_, shape) in
              block_param_spec(cfg, kind).items()}
             for kind in layer_kinds(cfg)]
    want = set(top) | ({"groups", "tail"} if layout == "groups"
                       else {layout})
    if set(params) != want:
        raise ValueError(f"expected {sorted(want)}, got {sorted(params)}")
    out = {k: _leaf(params[k], shape, k) for k, shape in top.items()}

    def check_names(tree, layers, where):
        names = set(specs[layers[0]])
        if not isinstance(tree, dict) or set(tree) != names:
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{where}: expected {sorted(names)}, got {got}")

    def unstack(tree, layers, where):
        """A stacked tree's leaves split onto ``layers``, in order."""
        check_names(tree, layers, where)
        for k, shape in specs[layers[0]].items():
            stacked = _leaf(tree[k], (len(layers), *shape), f"{where}/{k}")
            for i, piece in zip(layers, stacked):
                out[f"blocks.{i}.{k}"] = piece

    def one(tree, i, where):
        check_names(tree, [i], where)
        for k, shape in specs[i].items():
            out[f"blocks.{i}.{k}"] = _leaf(tree[k], shape, f"{where}/{k}")

    n = cfg.n_layers
    if layout == "blocks":
        unstack(params["blocks"], list(range(n)), "blocks")
    elif layout == "layers":
        if len(params["layers"]) != n:
            raise ValueError(f"layers: {len(params['layers'])} entries, "
                             f"expected {n}")
        for i, lp in enumerate(params["layers"]):
            one(lp, i, f"layers/{i}")
    else:
        plen = len(cfg.block_pattern)
        n_groups, n_tail = hybrid_grouping(cfg)
        if len(params["groups"]) != plen or len(params["tail"]) != n_tail:
            raise ValueError(
                f"groups / tail: {len(params['groups'])} and "
                f"{len(params['tail'])} entries, expected {plen} and "
                f"{n_tail}")
        for j, gp in enumerate(params["groups"]):
            unstack(gp, list(range(j, n_groups * plen, plen)),
                    f"groups/{j}")
        for j, lp in enumerate(params["tail"]):
            one(lp, n_groups * plen + j, f"tail/{j}")
    return out


def adamw_state_from_reference(state, cfg: ModelConfig) -> AdamWState:
    """The port's :class:`AdamWState` from the reference's ``(step, mu,
    nu)``, its moment trees as numpy: the stacked ``blocks`` split per
    layer as in :func:`transformer_params_from_reference`, each moment in
    ``cfg.moment_dtype`` on the CPU."""
    step, mu, nu = state
    dt = resolve_moment_dtype(cfg.moment_dtype)

    def moments(tree):
        return {k: v.to(dt) for k, v in
                transformer_params_from_reference(tree, cfg).items()}

    return AdamWState(step=int(np.asarray(step)), mu=moments(mu),
                      nu=moments(nu))


def _leaf(a, shape, name: str) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    if a.shape != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, expected {tuple(shape)}")
    return torch.from_numpy(a.copy())
