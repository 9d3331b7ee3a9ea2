"""The sharded train step: FSDP over 'data', data parallelism over 'pod'
and Megatron tensor parallelism over 'model', on a DeviceMesh.

The reference jits its step with ``train/sharding.py``'s shardings and
lets XLA's SPMD partitioner place the collectives: it scans the layers
over layer-stacked weights and the micro-batches over the batch, so each
layer's weights are gathered inside the scan body where they are used,
and each gradient leaves by a reduce-scatter into its parameter's
sharding.  Here the same collectives are explicit, around the one-device
step's arithmetic:

  * **Storage.**  Every parameter is a DTensor with
    ``sharding.param_placements`` (``Shard`` on the mesh dims its rule
    names, ``Replicate`` elsewhere) over this rank's block (the leaf the
    step differentiates and AdamW updates), every AdamW moment a DTensor
    with ``sharding.moment_placements`` (the parameter's, plus ZeRO over
    'pod').  Between steps a rank holds these and nothing else: the
    model's whole parameters are released when the blocks are cut.
  * **Gather on use.**  The model reads every weight through
    :meth:`ShardedModel.weight` (``Transformer.read_from``) when it uses
    it: a block's weights when the block runs (inside its checkpointed
    region under remat, so the backward's recompute gathers them again),
    the embedding, final norm and head where the forward reaches them.
    Each is all-gathered then from its storage block over 'pod' and
    'data' and dropped after.  Over 'model' it stays split where the
    model runs tensor parallel (:func:`model_parallel`: every family but
    the ssm, whose FFN units (each expert's), RG-LRU width and vocabulary
    split into whole blocks; ``models/tensor_parallel.py``), and is
    gathered too otherwise (the ssm, ``tensor_parallel=False``).  Where
    the query heads do not divide 'model', attention runs sequence
    parallel and its weights (``wq``, ``wk``, ``wv``, ``wo``) are
    gathered over 'model' while their storage stays split.  Where 'model'
    has more ranks than the model kv heads, ranks share a head: each
    gathers its head's columns from the ranks storing them.  On a mesh
    dim of one rank nothing moves: on a (1, 1) mesh the model reads the
    storage blocks themselves.
  * **Batch.**  Each rank runs its rows of the global batch
    (``sharding.batch_pspec``: the rows split over the batch axes, mesh
    order major first; 'model' is one of them for a config with
    ``tensor_parallel=False``, the reference's pure data parallelism),
    with the one-device step's micro-batch loop, its float32
    accumulators in the storage blocks' shapes.
  * **Reduce-scatter on use.**  The gather's backward
    (:class:`_GatherOnUse`) sums each micro-batch's gradient over the
    dims it gathered on which the ranks' shares differ (the batch axes;
    'model' for sequence-parallel attention's weights where the step
    split the sequence, ``TensorParallel.partial_grads``) by a
    reduce-scatter into this rank's storage block, cuts the block out
    where they do not, and sums a shared kv head's over its
    ``kv_group``.  After the micro-batches :meth:`ShardedModel.reduce`
    does what is left: the replicated weights' partial sums over 'model'
    (the router, the per-head norms, and where the step split the
    residual stream by sequence, its norms) and the all-reduce over the
    batch axes a leaf is stored whole on ('pod'), then the division by
    the number of row blocks, so the gradients are the global batch's
    mean in the storage blocks.
  * **int8.**  With ``compress_grads`` the round trip runs on the whole
    reduced gradient (gathered from the storage blocks), its 256-element
    blocks over each leaf as the reference stacks it
    (``trainer.int8_round_trip``), as without a mesh.  The reference's
    step keeps no error-feedback state, so neither does this one.
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

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from repro_torch.models.pspec_utils import (NamedPlacements, equivalent,
                                            mesh_axes, move, shard)
from repro_torch.models.tensor_parallel import (ATTN_WEIGHTS, KV_WEIGHTS,
                                               TensorParallel, scatter_sum)
from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamWState, adamw_update
from repro_torch.train.sharding import (batch_pspec, moment_placements,
                                        param_placements)


def model_parallel(cfg, mesh) -> TensorParallel | None:
    """This rank's share of the mesh's 'model' group, when the model runs
    tensor parallel over it: a 'model' dim of more than one rank,
    ``cfg.tensor_parallel``, and ``TensorParallel.fits`` (every family
    but the ssm, its FFN units, RG-LRU width and vocabulary splitting
    into whole blocks).  The residual stream splits by sequence with
    ``cfg.seq_parallel``; attention splits by heads where
    ``TensorParallel.heads_split``, else by query sequence (``seq_attn``).
    Where ranks share kv heads, their groups are made here, every rank
    making every group in the same order.  None otherwise (the
    parameters are then gathered over 'model' too, and every rank of the
    group runs the same rows)."""
    names = mesh.mesh_dim_names
    if "model" not in names:
        return None
    size = mesh.shape[names.index("model")]
    if size == 1 or not cfg.tensor_parallel or \
            not TensorParallel.fits(cfg, size):
        return None
    rank = mesh.get_local_rank("model")
    heads = TensorParallel.heads_split(cfg, size)
    share = TensorParallel.kv_share_of(cfg, size) if heads else 1
    kv_group = None
    if share > 1:
        # every 'model' group of the mesh, split into runs of `share`; the
        # mesh spans the group in row-major order, as init_device_mesh
        # lays it out (in numpy: under a FakeTensorMode the mesh's own
        # rank tensor is fake)
        ranks = np.moveaxis(np.arange(mesh.size()).reshape(mesh.shape),
                            names.index("model"), -1).reshape(-1, size)
        mine = dist.get_process_group_ranks(mesh.get_group("model"))
        if sorted(mine) not in ranks.tolist():
            raise ValueError("tensor parallelism with shared kv heads needs "
                             "a row-major mesh over the whole group")
        kv_group, _ = dist.new_subgroups_by_enumeration(
            [sorted(int(r) for r in row[i:i + share])
             for row in ranks for i in range(0, size, share)])
    return TensorParallel(mesh.get_group("model"), rank, size, kv_group,
                          share, seq=cfg.seq_parallel, seq_attn=not heads)


def batch_rows(mesh, batch_size: int, include_model: bool = False
               ) -> tuple[slice, tuple, int]:
    """(this rank's rows of a global batch, the mesh dims they are split
    over, the number of row blocks), as ``batch_pspec`` lays the batch
    out: over 'pod' and 'data', and over 'model' too with
    ``include_model`` (the pure data parallelism of a config with
    ``tensor_parallel=False``)."""
    spec = batch_pspec(mesh_axes(mesh), batch_size, 2, include_model)[0]
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


class _GatherOnUse(torch.autograd.Function):
    """A leaf's storage block -> the block the step runs
    (:meth:`ShardedModel.gather`); the gradient, summed over the ranks
    whose shares of it differ, back to the storage block
    (:meth:`ShardedModel.scatter`)."""

    @staticmethod
    def forward(ctx, local, sm, name):
        ctx.sm, ctx.name, ctx.summed = sm, name, sm.summed(name)
        return sm.gather(name, local)

    @staticmethod
    def backward(ctx, g):
        return ctx.sm.scatter(ctx.name, g, ctx.summed), None, None


class ShardedModel:
    """A model's parameters as DTensors on ``mesh`` (``params``, by name)
    over this rank's storage blocks (``leaves``, the tensors the step
    differentiates and AdamW updates), and ``module``, the model the step
    runs.  The module keeps no parameter of its own: it reads each weight
    through :meth:`weight` when it uses it (``Transformer.read_from``),
    gathered from the storage block then and dropped after.  Built from a
    model every rank initialized whole from the same seed, each rank
    keeping its blocks; the whole parameters are released.  ``decode``
    lays the parameters out as the reference's decode step does
    (``param_placements(decode=True)``: the embedding split by
    ``d_model`` over 'model')."""

    def __init__(self, model: Transformer, mesh, decode: bool = False):
        self.module, self.mesh, self.cfg = model, mesh, model.cfg
        self.param_pl = param_placements(self.cfg, mesh, decode=decode)
        self.moment_pl = moment_placements(self.cfg, mesh)
        self.tp = model_parallel(self.cfg, mesh)
        self.compute_pl = {
            n: tuple(p if d == "model" and self._split(n) else Replicate()
                     for d, p in zip(mesh.mesh_dim_names, pl))
            for n, pl in self.param_pl.items()}
        named = dict(model.named_parameters())
        with torch.no_grad():
            self.params = {n: shard(p.detach(), mesh, self.param_pl[n])
                           for n, p in named.items()}
        self.leaves = {n: dt.to_local().detach().requires_grad_(
            named[n].requires_grad) for n, dt in self.params.items()}
        del named
        self.axes, self.seq = (), False
        if self.tp is not None:
            model.set_tensor_parallel(self.tp)
        model.read_from(self.weight)

    @property
    def device(self) -> torch.device:
        return self.module.device

    def _split(self, name: str) -> bool:
        """Whether the step runs ``name`` split over 'model' as it is
        stored: under tensor parallelism, all but sequence-parallel
        attention's weights."""
        return self.tp is not None and not (
            self.tp.seq_attn and name.rpartition(".")[2] in ATTN_WEIGHTS)

    def _kv(self, name: str) -> bool:
        """Whether ``name`` is a kv projection whose head ranks share."""
        return self.tp is not None and self.tp.kv_share > 1 and \
            name.rpartition(".")[2] in KV_WEIGHTS

    # ---- gather on use ----
    def trainable(self, axes: tuple, seq: bool) -> dict:
        """The storage blocks, by name, with their gradients on, for a
        step whose rows split over the mesh dims ``axes`` and whose
        residual stream splits by sequence with ``seq``
        (:meth:`splits`): what :meth:`summed` reads."""
        self.axes, self.seq = tuple(axes), seq
        return {n: t.requires_grad_(True) for n, t in self.leaves.items()}

    def summed(self, name: str) -> frozenset:
        """The mesh dims over which ``name``'s gradient on this rank is a
        partial sum: the step's batch axes, and 'model' for a weight the
        model runs on this rank's share alone
        (``TensorParallel.partial_grads``)."""
        dims = set(self.axes)
        if self.tp is not None and \
                name.rpartition(".")[2] in self.tp.partial_grads(self.seq):
            dims.add("model")
        return frozenset(dims)

    def weight(self, name: str) -> torch.Tensor:
        """``name`` in the layout the step runs, gathered now from this
        rank's storage block (the module's every read of a weight comes
        here).  Where autograd records, through :class:`_GatherOnUse`, so
        the gradient leaves in the storage block; the storage block itself
        where nothing moves (every dim the layouts differ on has one rank,
        as on a (1, 1) mesh)."""
        leaf = self.leaves[name]
        if equivalent(self.mesh, self.param_pl[name],
                      self.compute_pl[name]) and not self._kv(name):
            return leaf
        if torch.is_grad_enabled() and leaf.requires_grad:
            return _GatherOnUse.apply(leaf, self, name)
        return self.gather(name, leaf)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """``name``'s storage block ``local`` -> its block in the layout
        the step runs (gathered over 'pod' and 'data', and over 'model'
        where the step runs it whole; a shared kv head's columns gathered
        in its ``kv_group``)."""
        t = move(local, self.mesh, self.param_pl[name], self.compute_pl[name])
        return self.tp.gather_kv(t) if self._kv(name) else t

    def scatter(self, name: str, g: torch.Tensor, summed: frozenset
                ) -> torch.Tensor:
        """The gradient of :meth:`gather`'s output -> this rank's storage
        block of it: on each mesh dim :meth:`gather` joined,
        reduce-scattered where the ranks' shares differ (``summed``) and
        cut to this rank's block where they are the same; then a shared kv
        head's summed in its ``kv_group`` (last, on the smallest block:
        the head's ranks hold the same rows of it)."""
        mesh = self.mesh
        for d, cp, sp, size in zip(mesh.mesh_dim_names, self.compute_pl[name],
                                   self.param_pl[name], mesh.shape):
            if size == 1 or not (sp.is_shard() and cp.is_replicate()):
                continue
            if d in summed:
                g = scatter_sum(g, sp.dim, mesh.get_group(d), size)
            else:
                g = g.chunk(size, dim=sp.dim)[mesh.get_local_rank(d)] \
                    .contiguous()
        return self.tp.reduce_kv(g) if self._kv(name) else g

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

    def splits(self, batch: dict) -> bool:
        """Whether the step on ``batch`` splits the residual stream by
        sequence (``TensorParallel.splits`` of its length: the frames', or
        the vision tokens' and the tokens')."""
        return self.tp is not None and self.tp.splits(sum(
            batch[k].shape[1] for k in ("frames", "vision", "tokens")
            if k in batch))

    # ---- the step's collectives ----
    def reduce(self, loss, grads: dict, n: int):
        """What is left of the sums after the micro-batches, each of whose
        gradients left :meth:`scatter` as a storage block: each gradient
        all-reduced over the dims of :meth:`summed` it is stored whole on
        (a replicated weight's partial sums over 'model', the batch axes
        the leaf is replicated over), then the loss over the batch axes,
        and both divided by the number of row blocks ``n``."""
        names = self.mesh.mesh_dim_names
        sizes = dict(zip(names, self.mesh.shape))
        for k, g in grads.items():
            summed = self.summed(k)
            for d, p in zip(names, self.param_pl[k]):
                if d in summed and p.is_replicate() and sizes[d] > 1:
                    dist.all_reduce(g, group=self.mesh.get_group(d))
        if n == 1:
            return loss, grads
        loss = loss.clone()
        for a in self.axes:
            dist.all_reduce(loss, group=self.mesh.get_group(a))
        for t in (loss, *grads.values()):
            t.div_(n)
        return loss, grads

    def whole(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A gradient's storage block, gathered whole."""
        pl = self.param_pl[name]
        return move(g, self.mesh, pl, (Replicate(),) * len(pl))

    def to_storage(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's storage block of a gradient every rank holds
        whole."""
        pl = self.param_pl[name]
        return move(g, self.mesh, (Replicate(),) * len(pl), pl)

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

