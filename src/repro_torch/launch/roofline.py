# RooflineTerms and model_flops copied from src/repro/launch/roofline.py;
# roofline_from_terms and the three rates are adapted (the H100's in place
# of the reference's TPU's; their lines are listed in
# tests/test_torch_compiler_copy.py).  CommCounter, which counts a step's
# collectives and bytes where the reference parses XLA's HLO text, is this
# package's own.
"""Roofline terms of a dry-run cell, on H100 SXM constants.

Three terms per (arch x shape x mesh), in seconds, per rank:

    compute    = FLOPs / 989e12          (dense bf16 peak)
    memory     = bytes / 3.35e12         (HBM3)
    collective = collective_bytes / 450e9

The link term takes NVLink 4's 450 GB/s a GPU in one direction (18 links
of 25 GB/s).  A host holds 8 GPUs in one NVLink domain; a mesh axis of
more than 8 ranks (the production 'model' and 'data' axes have 16) leaves
it for the network between hosts, which is slower, so there the link term
is a floor, not an estimate.

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and
parses the post-SPMD HLO for the collectives' output bytes
(``collective_bytes_from_hlo``).  PyTorch runs eagerly and has neither, so
:class:`CommCounter`, a ``TorchDispatchMode``, watches the step's
operators as they dispatch:

  * ``collectives``: the output bytes of every collective, summed under
    the reference's five kinds, from both operator families: ``c10d.*``
    (``allreduce_``, ``allgather_``, ``_reduce_scatter_base_``, ..., what
    ``torch.distributed``'s calls dispatch) and ``_c10d_functional.*``
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``, ..., what DTensor's redistributions dispatch);
  * ``bytes_per_device``: the input and output bytes of every operator
    that writes a new tensor (not a view of its input, an allocation or a
    wait).  That is the traffic the port's eager step moves, each
    operator reading its inputs from memory and writing its outputs
    there; a fused program moves less.  Under ``inference_mode`` (the
    serving steps) composite operators (``einsum``, ``matmul``, ``to``)
    reach the mode whole, and count as one operator each.

Like ``MemTracker`` it lets a DTensor operator unwrap first, so it counts
the local operators (and the collectives) each rank runs.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
products, convolutions and attention).
"""
from __future__ import annotations

from dataclasses import dataclass, asdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12       # dense bf16 / H100 SXM

HBM_BW = 3.35e12          # bytes/s / H100 SXM (HBM3)

LINK_BW = 450e9           # bytes/s / GPU, NVLink 4, one direction

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_KINDS = (("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
          ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
          ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"), ("send", "collective-permute"),
          ("recv", "collective-permute"), ("p2p", "collective-permute"))
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
_NO_TRAFFIC = ("wait_tensor", "barrier", "monitored_barrier", "empty",
               "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "_wrap_tensor_autograd",
               "_unsafe_view")


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _aliases(out, inputs) -> bool:
    """Whether every tensor ``out`` holds is a view of one of ``inputs``
    (a view, or an operator that may alias, as ``to`` or ``contiguous``,
    where it returned its input)."""
    ins = [t for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)]
    return all(any(torch._C._is_alias_of(o, i) for i in ins)
               for o in tree_leaves(out) if isinstance(o, torch.Tensor))


def collective_kind(func) -> str | None:
    """The reference's kind of a collective operator (by the first
    fragment of ``_KINDS`` in its name), ``"other"`` for a collective of
    none of them (a broadcast), None for any other operator."""
    if func.namespace not in _COMM_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    if name in _NO_TRAFFIC:
        return None
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return "other"


class CommCounter(TorchDispatchMode):
    """Per-rank collective output bytes by kind (``collectives``; the
    reference's five keys, plus ``other`` if a collective of no such kind
    ran), their operator counts (``counts``), and the input and output
    bytes of every other operator that moves data (``bytes``)."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = collective_kind(func)
        if kind is not None:
            # c10d's in-place collectives write their first argument (and
            # some return only a Work): count what they write
            moved = _tensor_bytes(out)
            if func.namespace == "c10d":
                moved = _tensor_bytes(args[0]) if args else moved
            self.collectives[kind] = self.collectives.get(kind, 0) + moved
            self.counts[kind] = self.counts.get(kind, 0) + 1
        elif func._schema.name.split("::")[-1] not in _NO_TRAFFIC and \
                not (func.is_view and _aliases(out, (args, kwargs))):
            moved = _tensor_bytes(out)
            if moved:       # an operator that writes no tensor reads none
                self.bytes += _tensor_bytes((args, kwargs)) + moved
        return out


@dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops_total: float       # 6*N*D or 2*N*D
    hlo_flops_total: float
    useful_flops_ratio: float
    chips: int

    def to_dict(self):
        return asdict(self)


def roofline_from_terms(*, flops_per_device: float, bytes_per_device: float,
                        collective_breakdown: dict, chips: int,
                        model_flops_total: float) -> RooflineTerms:
    flops, raw_bytes = flops_per_device, bytes_per_device
    coll = collective_breakdown
    coll_bytes = float(sum(coll.values()))
    compute_s = flops / PEAK_FLOPS
    memory_s = raw_bytes / HBM_BW
    collective_s = coll_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    hlo_total = flops * chips
    return RooflineTerms(
        flops_per_device=flops, bytes_per_device=raw_bytes,
        collective_bytes_per_device=coll_bytes, collective_breakdown=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound=bound, model_flops_total=model_flops_total,
        hlo_flops_total=hlo_total,
        useful_flops_ratio=(model_flops_total / hlo_total
                            if hlo_total else 0.0),
        chips=chips)


def model_flops(cfg, cell, n_tokens: int | None = None) -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference), N = active params."""
    n_active = cfg.param_count(active_only=True)
    if n_tokens is None:
        if cell.kind == "train":
            n_tokens = cell.global_batch * cell.seq_len
        elif cell.kind == "prefill":
            n_tokens = cell.global_batch * cell.seq_len
        else:
            n_tokens = cell.global_batch * 1
    mult = 6 if cell.kind == "train" else 2
    return float(mult * n_active * n_tokens)
