# activation_sharding, active_mesh, dp_axes and _resolve are copied from
# src/repro/models/pspec_utils.py; the rest is this package's own (DTensor
# placements and layouts on a DeviceMesh, and constrain over them).
"""Activation sharding constraints, mesh-context aware but test-friendly.

Model code calls ``constrain(x, 'dp', None, None)`` with *logical* axes:
  'dp'    -> shard over ('pod','data') (whichever exist in the mesh)
  'model' -> shard over 'model'
  None    -> replicated dim

The trainer activates a mesh (a ``torch.distributed`` ``DeviceMesh`` with
named dims) via ``activation_sharding(mesh)``; without it (one device)
``constrain`` is a no-op, as in the reference.  With a mesh it
redistributes a DTensor to the resolved placements and returns any other
tensor as it is.  The sharded trainer runs the model on each rank's own
rows as plain tensors, and the split over 'model' that these annotations
ask for (the residual stream by sequence, sequence-parallel attention)
is written out by the model under tensor parallelism
(``models/tensor_parallel.py``), not by ``constrain``.  Dims that don't
divide the axis size degrade to replication.

The partition spec :class:`P` and the rule functions' view of a mesh,
:class:`Mesh` (its axis names and sizes), live here so both the model
code and ``train/sharding.py`` take them from one place.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)


class P(tuple):
    """A partition spec: one entry a tensor dim, each an axis name, a
    tuple of axis names (sharded over their product, the first major) or
    None (replicated).  Equality is the tuple's, as the reference's
    ``PartitionSpec``: ``P("data") != P(("data",))``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class Mesh:
    """What the rule functions read of a mesh: its axis names, in order,
    and their sizes (``shape`` maps a name to its size)."""

    def __init__(self, shape: dict):
        self._shape = dict(shape)

    @property
    def axis_names(self) -> tuple:
        return tuple(self._shape)

    @property
    def shape(self) -> dict:
        return self._shape


def mesh_axes(mesh) -> Mesh:
    """The :class:`Mesh` view of a ``DeviceMesh`` with named dims (a
    :class:`Mesh`, or anything with ``axis_names`` and a ``shape`` dict,
    passes through)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return Mesh(dict(zip(names, mesh.shape)))


def placements(mesh, spec: P) -> tuple:
    """``spec`` as DTensor placements on ``mesh`` (a DeviceMesh): on each
    mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose entry names it,
    ``Replicate()`` where no entry does."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def equivalent(mesh, a: tuple, b: tuple) -> bool:
    """Whether placements ``a`` and ``b`` lay a tensor out alike on
    ``mesh``: equal on every mesh dim of more than one rank."""
    return all(x == y or n == 1 for x, y, n in zip(a, b, mesh.shape))


def shard(full: torch.Tensor, mesh, pl: tuple) -> DTensor:
    """A DTensor with placements ``pl`` from ``full``, which every rank
    holds whole: each keeps its own block, with no collective.  Where
    ``pl`` splits nothing (every sharded mesh dim has one rank) the
    DTensor's local tensor is ``full`` itself, not a copy."""
    if equivalent(mesh, pl, (Replicate(),) * len(pl)):
        return DTensor.from_local(full, mesh, pl)
    local = distribute_tensor(full, mesh, pl, src_data_rank=None)
    return DTensor.from_local(local.to_local().clone(), mesh, pl)


def move(local: torch.Tensor, mesh, src: tuple, dst: tuple) -> torch.Tensor:
    """This rank's block of a tensor laid out ``src`` -> its block laid
    out ``dst`` (collectives where a dim gathers; ``local`` itself where
    the two are :func:`equivalent`)."""
    if equivalent(mesh, src, dst):
        return local
    return DTensor.from_local(local, mesh, src).redistribute(
        mesh, dst).to_local()


@dataclass(frozen=True)
class NamedPlacements:
    """A layout on a mesh, the counterpart of the reference's
    ``NamedSharding``: the DeviceMesh and one placement a mesh dim."""

    mesh: object
    placements: tuple

    def distribute(self, full: torch.Tensor) -> DTensor:
        return shard(full, self.mesh, self.placements)


_ACTIVE: Optional[Mesh] = None
_DP_AXES: tuple = ("pod", "data")


@contextlib.contextmanager
def activation_sharding(mesh: Mesh | None, dp_axes: tuple = ("pod", "data")):
    """dp_axes: which mesh axes carry the batch. Pure-DP configs
    (cfg.tensor_parallel=False) pass ('pod','data','model')."""
    global _ACTIVE, _DP_AXES
    prev, _ACTIVE = _ACTIVE, mesh
    prev_dp, _DP_AXES = _DP_AXES, dp_axes
    try:
        yield
    finally:
        _ACTIVE = prev
        _DP_AXES = prev_dp


def active_mesh() -> Mesh | None:
    return _ACTIVE


def dp_axes() -> tuple:
    return _DP_AXES


def _resolve(axis, dim: int, mesh: Mesh):
    if axis is None:
        return None
    if axis == "dp":
        names = tuple(n for n in _DP_AXES if n in mesh.axis_names)
        # biggest divisible contiguous subset (mirrors sharding.batch_pspec)
        best, best_total = None, 1
        for i in range(len(names)):
            for j in range(i + 1, len(names) + 1):
                total = 1
                for n in names[i:j]:
                    total *= mesh.shape[n]
                if dim % total == 0 and total > best_total:
                    best, best_total = names[i:j], total
        return best
    if axis in mesh.axis_names and dim % mesh.shape[axis] == 0:
        return axis
    return None


def resolve_spec(x, *axes) -> P:
    """The spec ``constrain`` gives ``x`` under the active mesh."""
    mesh = mesh_axes(_ACTIVE)
    if len(axes) != x.ndim:
        raise ValueError(f"spec rank {len(axes)} != tensor rank {x.ndim}")
    resolved, used = [], set()
    for a, d in zip(axes, x.shape):
        r = _resolve(a, d, mesh)
        names = (r,) if isinstance(r, str) else (r or ())
        if any(n in used for n in names):   # pure-DP: 'dp' may own 'model'
            r = None
        used.update(names)
        resolved.append(r)
    return P(*resolved)


def constrain(x, *axes):
    """``x`` laid out as the logical ``axes`` say under the active mesh: a
    DTensor is redistributed, anything else returned as it is; a no-op
    without an active mesh."""
    if _ACTIVE is None:
        return x
    spec = resolve_spec(x, *axes)
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))
