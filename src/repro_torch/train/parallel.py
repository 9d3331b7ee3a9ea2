"""The sharded train step: FSDP over 'data', data parallelism over 'pod'
and Megatron tensor parallelism over 'model', on a DeviceMesh.

The reference jits its step with ``train/sharding.py``'s shardings and
lets XLA's SPMD partitioner place the collectives.  Here they are
explicit, around the one-device step's arithmetic:

  * **Storage.**  Every parameter is a DTensor with
    ``sharding.param_placements`` (``Shard`` on the mesh dims its rule
    names, ``Replicate`` elsewhere), every AdamW moment a DTensor with
    ``sharding.moment_placements`` (the parameter's, plus ZeRO over
    'pod').
  * **Gather.**  Before a step each parameter is all-gathered over 'pod'
    and 'data' (FSDP's all-gather on use).  Over 'model' it stays split
    where the model runs tensor parallel (:func:`model_parallel`: the
    dense, vlm and moe families' heads, FFN units (each expert's) and
    vocabulary split into whole blocks; ``models/tensor_parallel.py``),
    and is gathered too otherwise: the ssm (``tensor_parallel=False``),
    the hybrid (one kv head) and audio (its GeLU MLP), which gives the
    reference's result either way.  On a mesh dim of one rank nothing
    moves: on a (1, 1) mesh the model's parameters are the DTensors' own
    local tensors.
  * **Batch.**  Each rank runs its rows of the global batch
    (``sharding.batch_pspec``: the rows split over the batch axes, mesh
    order major first), with the one-device step's micro-batch loop.
  * **Reduce.**  The loss and each gradient are all-reduced over the
    batch axes and divided by their number of shards, so they are the
    global batch's mean; the gradients then keep this rank's block of
    each parameter's placements.
  * **int8.**  With ``compress_grads`` the round trip runs on the whole
    reduced gradient (gathered over 'model'), its 256-element blocks over
    each leaf as the reference stacks it (``trainer.int8_round_trip``), as
    without a mesh.  The reference's step keeps no error-feedback state,
    so neither does this one.
  * **Clip.**  The global norm sums each leaf's squares once (on the rank
    at coordinate 0 of every mesh dim the leaf is replicated over), then
    all-reduces the sum over the mesh.
  * **AdamW.**  The one-device update on each rank's blocks; a parameter
    whose moments are split further (ZeRO over 'pod') is updated on the
    moments' block and all-gathered back over 'pod'.

The mesh must span the whole process group.  Nothing here runs a
collective on a one-rank mesh dim, so a (1, 1) mesh takes the one-device
step's every operation in the same order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate

from repro_torch.models.pspec_utils import (NamedPlacements, equivalent,
                                            mesh_axes, move, shard)
from repro_torch.models.tensor_parallel import PARTIAL_GRADS, TensorParallel
from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamWState, adamw_update
from repro_torch.train.sharding import (batch_pspec, moment_placements,
                                        param_placements)


def model_parallel(cfg, mesh) -> TensorParallel | None:
    """This rank's share of the mesh's 'model' group, when the model runs
    tensor parallel over it: a 'model' dim of more than one rank,
    ``cfg.tensor_parallel``, and ``TensorParallel.fits`` (a dense, vlm or
    moe model whose heads, FFN units and vocabulary split into whole
    blocks).  None otherwise (the parameters are then gathered over
    'model' too, and every rank of the group runs the same rows)."""
    names = mesh.mesh_dim_names
    if "model" not in names:
        return None
    size = mesh.shape[names.index("model")]
    if size == 1 or not cfg.tensor_parallel or \
            not TensorParallel.fits(cfg, size):
        return None
    return TensorParallel(mesh.get_group("model"),
                          mesh.get_local_rank("model"), size)


def batch_rows(mesh, batch_size: int) -> tuple[slice, tuple, int]:
    """(this rank's rows of a global batch, the mesh dims they are split
    over, the number of row blocks), as ``batch_pspec`` lays the batch
    out."""
    spec = batch_pspec(mesh_axes(mesh), batch_size, 2)[0]
    axes = () if spec is None else (spec,) if isinstance(spec, str) \
        else tuple(spec)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n, idx = 1, 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    per = batch_size // n
    return slice(idx * per, (idx + 1) * per), axes, n


class ShardedModel:
    """A model's parameters as DTensors on ``mesh`` (``params``, by name),
    and ``module``, the model the step runs, whose parameters are the
    gathered blocks (:meth:`gather`).  Built from a model every rank
    initialized whole from the same seed, each rank keeping its blocks."""

    def __init__(self, model: Transformer, mesh):
        self.module, self.mesh, self.cfg = model, mesh, model.cfg
        self.param_pl = param_placements(self.cfg, mesh)
        self.moment_pl = moment_placements(self.cfg, mesh)
        self.tp = model_parallel(self.cfg, mesh)
        self.compute_pl = {
            n: tuple(p if d == "model" and self.tp is not None
                     else Replicate()
                     for d, p in zip(mesh.mesh_dim_names, pl))
            for n, pl in self.param_pl.items()}
        with torch.no_grad():
            self.params = {n: shard(p.detach(), mesh, self.param_pl[n])
                           for n, p in model.named_parameters()}
        if self.tp is not None:
            model.set_tensor_parallel(self.tp)
        self.gather()

    @property
    def device(self) -> torch.device:
        return self.module.device

    def _set(self, name: str, t: torch.Tensor) -> None:
        mod, _, leaf = name.rpartition(".")
        setattr(self.module.get_submodule(mod) if mod else self.module,
                leaf, nn.Parameter(t, requires_grad=True))

    @torch.no_grad()
    def gather(self) -> None:
        """Give the module each parameter's blocks in the layout the step
        runs (gathered over 'pod' and 'data', and over 'model' unless
        tensor parallel)."""
        for n, dt in self.params.items():
            self._set(n, move(dt.to_local(), self.mesh, self.param_pl[n],
                              self.compute_pl[n]))

    def init_opt(self, moment_dtype) -> AdamWState:
        """Zero AdamW moments with ``moment_placements``."""
        def zeros(n):
            return shard(torch.zeros(self.params[n].shape,
                                     dtype=moment_dtype,
                                     device=self.device),
                         self.mesh, self.moment_pl[n])
        return AdamWState(step=0, mu={n: zeros(n) for n in self.params},
                          nu={n: zeros(n) for n in self.params})

    def layouts(self) -> dict:
        """The checkpoint tree's layouts (``CheckpointManager.restore``'s
        ``shardings``)."""
        moments = {n: NamedPlacements(self.mesh, pl)
                   for n, pl in self.moment_pl.items()}
        return {"params": {n: NamedPlacements(self.mesh, pl)
                           for n, pl in self.param_pl.items()},
                "opt": AdamWState(step=None, mu=moments, nu=moments)}

    @torch.no_grad()
    def load(self, params: dict) -> None:
        """Copy restored DTensors (the same placements) into ``params``."""
        for n, dt in self.params.items():
            dt.to_local().copy_(params[n].to_local())

    def full_state_dict(self) -> dict:
        """Every parameter whole, on every rank (a collective)."""
        return {n: dt.full_tensor() for n, dt in self.params.items()}

    # ---- the step's collectives ----
    def reduce(self, loss, grads: dict, axes: tuple, n: int):
        """Sum the loss and gradients over the batch axes, then divide by
        the number of row blocks; under tensor parallelism first sum the
        partial gradients of :data:`PARTIAL_GRADS` over 'model'."""
        if self.tp is not None:
            for k, g in grads.items():
                if k.rpartition(".")[2] in PARTIAL_GRADS:
                    dist.all_reduce(g, group=self.tp.group)
        if n == 1:
            return loss, grads
        loss = loss.clone()
        for t in (loss, *grads.values()):
            for a in axes:
                dist.all_reduce(t, group=self.mesh.get_group(a))
            t.div_(n)
        return loss, grads

    def whole(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A gradient in the step's layout, gathered whole."""
        pl = self.compute_pl[name]
        return move(g, self.mesh, pl, (Replicate(),) * len(pl))

    def to_storage(self, name: str, g: torch.Tensor, src=None
                   ) -> torch.Tensor:
        """This rank's block of a gradient in its parameter's placements
        (``g`` laid out ``src``, the step's layout by default)."""
        return move(g, self.mesh, src or self.compute_pl[name],
                    self.param_pl[name])

    def clip(self, grads: dict, max_norm: float
             ) -> tuple[dict, torch.Tensor]:
        """``optim.clip_by_global_norm`` over the gradients' blocks: the
        norm of the whole gradient, each leaf's squares counted once."""
        coord = self.mesh.get_coordinate()
        owned = [g for n, g in grads.items()
                 if all(c == 0 for c, p in zip(coord, self.param_pl[n])
                        if p.is_replicate())]
        total = sum((torch.sum(torch.square(g.float())) for g in owned),
                    torch.zeros((), dtype=torch.float32,
                                device=self.device))
        if self.mesh.size() > 1:
            dist.all_reduce(total)
        norm = torch.sqrt(total)
        scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
        return {k: (g.float() * scale).to(g.dtype)
                for k, g in grads.items()}, norm

    def adamw(self, grads: dict, opt: AdamWState, *, lr,
              weight_decay: float) -> AdamWState:
        """``optim.adamw_update`` on each rank's blocks, in place."""
        params, g_m, zero = {}, {}, []
        for n, dt in self.params.items():
            ppl, mpl = self.param_pl[n], self.moment_pl[n]
            params[n] = move(dt.to_local(), self.mesh, ppl, mpl)
            g_m[n] = move(grads[n], self.mesh, ppl, mpl)
            if not equivalent(self.mesh, ppl, mpl):
                zero.append(n)
        state = AdamWState(opt.step,
                           {n: v.to_local() for n, v in opt.mu.items()},
                           {n: v.to_local() for n, v in opt.nu.items()})
        _, new = adamw_update(g_m, state, params, lr=lr,
                              weight_decay=weight_decay)
        with torch.no_grad():
            for n in zero:      # ZeRO over 'pod': gather the update back
                self.params[n].to_local().copy_(move(
                    params[n], self.mesh, self.moment_pl[n],
                    self.param_pl[n]))
        return opt._replace(step=new.step)

