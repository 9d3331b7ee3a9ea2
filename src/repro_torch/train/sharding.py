# _RULES, _MOE_3D, _axis, _shard_if, leaf_pspec, param_pspecs,
# moment_pspecs, dp_axes, batch_pspec and cache_pspecs are copied from
# src/repro/train/sharding.py; param_shapes and the *_placements
# functions (DTensor placements on a DeviceMesh) are this package's own.
"""Sharding rules: FSDP ('data') x TP ('model'), pod-replicated params.

Posture: the 'pod' axis carries only data parallelism whose gradient
all-reduce is the single cross-pod collective; 'data' carries FSDP
(params/optimizer sharded, weights all-gathered on use); 'model' carries
tensor parallelism (Megatron column/row).

Per-leaf rules are by parameter *name* (names are globally unique across
families). A dim is sharded only when divisible by the axis size —
``_shard_if`` degrades to replication otherwise.

The rule functions are the reference's, verbatim: pure Python over a
mesh's axis names and sizes (``models.pspec_utils.Mesh``; a ``DeviceMesh``
goes through ``mesh_axes``) and leaves with a ``shape``, returning
:class:`~repro_torch.models.pspec_utils.P` specs.  The reference's
``*_shardings`` become ``*_placements``: each spec as DTensor placements
on a ``torch.distributed`` ``DeviceMesh`` with named dims, ``Shard(d)`` on
the mesh dim a spec entry names and ``Replicate()`` elsewhere
(``pspec_utils.placements``).

The port's model keeps one leaf a layer (``blocks.{i}.{name}``) where the
reference stacks the layers on a leading axis.  A layer's leaf takes the
reference's stacked spec without that axis: the rule functions walk the
per-layer tree (:func:`param_shapes` with ``layout="layers"``), where
``leaf_pspec`` gives the body's spec that the stacked one prefixes with
None.  The moments' ZeRO-over-'pod' rule (``moment_pspecs``: the first
replicated dim that 'pod' divides) then applies to each layer's leaf on
its own dims, where the reference's stack would take its layer axis.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.convert import reference_layout
from repro_torch.models.layers import DTYPES
from repro_torch.models.pspec_utils import Mesh, P, mesh_axes, placements
from repro_torch.models.transformer import (block_param_spec,
                                            hybrid_grouping, layer_kinds,
                                            param_spec)


_RULES: dict[str, tuple] = {
    # embeddings / heads
    "embed": ("tp", "fsdp"),            # (V, D)
    "lm_head": ("fsdp", "tp"),          # (D, V)
    "head": ("fsdp", "tp"),             # (D, V) audio
    "frontend_proj": (None, "fsdp"),    # (frontend, D)
    # attention
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "q_norm": (None,), "k_norm": (None,),
    # dense mlp
    "w_in": ("fsdp", "tp"), "w_out": ("tp", "fsdp"),
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (E, D, F) / (E, F, D): experts replicated, TP on F, FSDP on D
    "w_router": ("fsdp", None),
    # ssm
    "in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"),
    "dt_bias": ("tp",), "a_log": ("tp",), "skip_d": ("tp",),
    "out_norm": ("tp",), "out_proj": ("tp", "fsdp"),
    # rglru (hybrid)
    "gate_proj": ("fsdp", "tp"), "rnn_proj": ("fsdp", "tp"),
    "w_a": (None, "tp"), "b_a": ("tp",), "w_x": (None, "tp"),
    "b_x": ("tp",), "lam": ("tp",),
    # norms
    "attn_norm": (None,), "mlp_norm": (None,), "norm": (None,),
    "final_norm": (None,),
}


_MOE_3D = {"w_gate": (None, "fsdp", "tp"), "w_up": (None, "fsdp", "tp"),
           "w_down": (None, "tp", "fsdp")}


def _axis(mesh: Mesh, logical: str | None) -> str | None:
    if logical is None:
        return None
    name = {"fsdp": "data", "tp": "model"}[logical]
    return name if name in mesh.axis_names else None


def _shard_if(mesh: Mesh, dim: int, axis: str | None):
    """Shard only when divisible; otherwise replicate this dim."""
    if axis is None or axis not in mesh.axis_names:
        return None
    if dim % mesh.shape[axis] != 0:
        return None
    return axis


def leaf_pspec(mesh: Mesh, name: str, shape: tuple, stacked: bool) -> P:
    body_shape = shape[1:] if stacked else shape
    rule = _RULES.get(name)
    if rule is not None and len(rule) != len(body_shape) and name in _MOE_3D:
        rule = None
    if name in _MOE_3D and len(body_shape) == 3:
        rule = _MOE_3D[name]
    if rule is None or len(rule) != len(body_shape):
        rule = (None,) * len(body_shape)
    axes = [_shard_if(mesh, d, _axis(mesh, r))
            for d, r in zip(body_shape, rule)]
    if stacked:
        axes = [None] + axes
    return P(*axes)


def param_pspecs(cfg, mesh: Mesh, shapes: Any, decode: bool = False) -> Any:
    """PartitionSpec pytree matching ``param_spec``-built params.

    cfg.tensor_parallel=False drops every 'model'-axis placement (params
    replicated across 'model'; the batch occupies it instead).

    decode=True lays the embedding out (D -> 'model') instead of
    (V -> 'model', D -> 'data'): a token gather over a vocab-sharded table
    triggers SPMD's involuntary full rematerialization every step; the
    D-sharded layout makes the lookup collective-free (§Perf)."""

    def strip_model(spec: P) -> P:
        return P(*[None if a == "model" else a for a in spec])

    def walk(node, name=None, stacked=False):
        if isinstance(node, dict):
            return {k: walk(v, k, stacked or k in ("blocks", "groups"))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, stacked and name != "tail")
                    for v in node]
        if decode and name == "embed":
            spec = P(None, _shard_if(mesh, node.shape[-1], "model"))
        else:
            spec = leaf_pspec(mesh, name, tuple(node.shape), stacked)
        return spec if cfg.tensor_parallel else strip_model(spec)

    return walk(shapes)


def moment_pspecs(cfg, mesh: Mesh, shapes: Any) -> Any:
    """Optimizer-moment specs: param spec + ZeRO-style 'pod' sharding.

    Moments are touched only at the update, never in fwd/bwd, so sharding
    them over the pod axis (on the leading stacked dim, which params keep
    replicated for the scan) costs no hot-path collectives and halves the
    per-device optimizer footprint on the 2-pod mesh."""
    base = param_pspecs(cfg, mesh, shapes)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, s) for v, s in zip(node, spec)]
        parts = list(spec) + [None] * (len(node.shape) - len(spec))
        if "pod" in mesh.axis_names:
            for i, (dim, p) in enumerate(zip(node.shape, parts)):
                if p is None and dim % mesh.shape["pod"] == 0:
                    parts[i] = "pod"
                    break
        return P(*parts)

    return walk(shapes, base)


def dp_axes(mesh: Mesh, include_model: bool = False) -> tuple:
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    return tuple(a for a in names if a in mesh.axis_names)


def batch_pspec(mesh: Mesh, batch_size: int, ndim: int,
                include_model: bool = False) -> P:
    """Shard the leading batch dim over the longest divisible DP-axis
    prefix (e.g. batch 32 on ('pod','data','model') falls back to
    ('pod','data'), then ('pod',), then replication)."""
    axes = dp_axes(mesh, include_model)
    best, best_total = None, 1
    for i in range(len(axes)):
        for j in range(i + 1, len(axes) + 1):
            sub = axes[i:j]
            total = int(np.prod([mesh.shape[a] for a in sub]))
            if batch_size % total == 0 and total > best_total:
                best, best_total = sub, total
    if best:
        # unwrap singleton axis tuples: P('data') and P(('data',)) shard
        # identically but compare unequal, and every consumer (and test)
        # spells the scalar form
        return P(best if len(best) > 1 else best[0],
                 *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def cache_pspecs(cfg, mesh: Mesh, cache_shapes) -> Any:
    """DecodeCache shardings: batch -> (pod,data); heads/C -> 'model'.

    KV (L, B, C, Hk, hd): when Hk divides |model| shard heads, else shard
    the *cache sequence* C over 'model' (sequence-sharded decode; the
    explicit-softmax decode path turns this into local partials + a small
    AllReduce). SSM state (L, B, H, P, N): H over 'model'. RG-LRU h
    (L, B, D_rnn): D_rnn over 'model'.
    """
    model = mesh.shape.get("model", 1)

    def spec(path_name, shape):
        nd = len(shape)
        if path_name in ("kv_k", "kv_v"):
            b_axes = batch_pspec(mesh, shape[1], 1)[0]
            if cfg.n_kv_heads % model == 0:
                return P(None, b_axes, None,
                         _shard_if(mesh, shape[3], "model"), None)
            return P(None, b_axes, _shard_if(mesh, shape[2], "model"),
                     None, None)
        if path_name == "ssm_state":
            return P(None, batch_pspec(mesh, shape[1], 1)[0],
                     _shard_if(mesh, shape[2], "model"), None, None)
        if path_name == "conv_carry":
            return P(None, batch_pspec(mesh, shape[1], 1)[0], None,
                     _shard_if(mesh, shape[3], "model"))
        if path_name == "rec_h":
            return P(None, batch_pspec(mesh, shape[1], 1)[0],
                     _shard_if(mesh, shape[2], "model"))
        if path_name == "rec_conv":
            return P(None, batch_pspec(mesh, shape[1], 1)[0], None,
                     _shard_if(mesh, shape[3], "model"))
        if path_name == "length":
            return P()
        return P(*([None] * nd))

    fields = cache_shapes._asdict()
    return type(cache_shapes)(**{
        k: (None if v is None else spec(k, tuple(v.shape)))
        for k, v in fields.items()})



def param_shapes(cfg, layout: str | None = None) -> dict:
    """The parameter tree the rule functions walk, each leaf a ``meta``
    tensor of the leaf's shape and dtype (nothing allocated): the
    top-level leaves, then the layers in ``layout`` — the reference's own
    (``convert.reference_layout``: ``blocks`` stacked, the hybrid's
    ``groups`` stacks + ``tail``, or ``layers``) by default, or
    ``"layers"``, one dict a layer, as the port's model keeps them."""
    dt = DTYPES[cfg.param_dtype]

    def leaf(shape):
        return torch.empty(shape, dtype=dt, device="meta")

    tree = {k: leaf(shape) for k, (_, shape) in param_spec(cfg).items()}
    kinds = layer_kinds(cfg)
    specs = [{k: shape for k, (_, shape) in block_param_spec(cfg, kind)
              .items()} for kind in kinds]

    def stack(layers):
        return {k: leaf((len(layers), *shape))
                for k, shape in specs[layers[0]].items()}

    layout = layout or reference_layout(cfg)
    n = cfg.n_layers
    if layout == "blocks":
        tree["blocks"] = stack(list(range(n)))
    elif layout == "groups":
        plen = len(cfg.block_pattern)
        n_groups, _ = hybrid_grouping(cfg)
        tree["groups"] = [stack(list(range(j, n_groups * plen, plen)))
                          for j in range(plen)]
        tree["tail"] = [{k: leaf(s) for k, s in specs[i].items()}
                        for i in range(n_groups * plen, n)]
    else:
        tree["layers"] = [{k: leaf(s) for k, s in spec.items()}
                          for spec in specs]
    return tree


def _by_name(tree: dict) -> dict:
    """A per-layer tree's leaves under the port's state-dict names."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree.get("layers", ())):
        out.update({f"blocks.{i}.{k}": v for k, v in layer.items()})
    return out


def flat_param_pspecs(cfg, mesh: Mesh, decode: bool = False) -> dict:
    """``param_pspecs`` of each of the port's parameters, by name."""
    return _by_name(param_pspecs(cfg, mesh, param_shapes(cfg, "layers"),
                                 decode=decode))


def flat_moment_pspecs(cfg, mesh: Mesh) -> dict:
    """``moment_pspecs`` of each of the port's parameters, by name."""
    return _by_name(moment_pspecs(cfg, mesh, param_shapes(cfg, "layers")))


def param_placements(cfg, mesh, decode: bool = False) -> dict:
    """Each parameter's DTensor placements on the DeviceMesh ``mesh``,
    by name."""
    return {k: placements(mesh, s) for k, s in
            flat_param_pspecs(cfg, mesh_axes(mesh), decode).items()}


def moment_placements(cfg, mesh) -> dict:
    """Each AdamW moment's DTensor placements on ``mesh``, by its
    parameter's name: the parameter's, plus ZeRO over 'pod'."""
    return {k: placements(mesh, s) for k, s in
            flat_moment_pspecs(cfg, mesh_axes(mesh)).items()}


def batch_placements(mesh, batch_size: int, ndim: int,
                     include_model: bool = False) -> tuple:
    """The batch's DTensor placements on ``mesh`` (``batch_pspec``)."""
    return placements(mesh, batch_pspec(mesh_axes(mesh), batch_size, ndim,
                                        include_model))


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def cache_placements(cfg, mesh, cache) -> Any:
    """A ``DecodeCache``'s DTensor placements on ``mesh``, field by field
    (None where the cache holds none; ``length``, a host int, is
    replicated)."""
    shapes = type(cache)(**{
        k: None if v is None else _Shape(np.shape(v) if k == "length"
                                         else v.shape)
        for k, v in cache._asdict().items()})
    specs = cache_pspecs(cfg, mesh_axes(mesh), shapes)
    return type(cache)(**{k: None if s is None else placements(mesh, s)
                          for k, s in specs._asdict().items()})
