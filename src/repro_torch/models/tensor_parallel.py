"""Megatron tensor parallelism over a mesh's 'model' dim, for the
training of the dense, vlm and moe families.

The reference leaves tensor parallelism to XLA's SPMD partitioner, which
splits each matrix product as ``train/sharding.py``'s rules lay the
weights out.  PyTorch runs eagerly, so the split is written out here
[Shoeybi et al. 2019, arXiv:1909.08053]: each rank of a 'model' group
holds a contiguous block of the query and key/value heads (``wq``, ``wk``,
``wv`` by column, ``wo`` by row), of the FFN's hidden units (``w_gate``,
``w_up`` by column, ``w_down`` by row) and of the vocabulary (``embed``
by row, ``lm_head`` by column) — exactly the blocks ``Shard`` on 'model'
gives them — and a block runs its own heads and units.  A MoE block's
experts split the same way, each rank holding the same F-block of every
expert (``w_gate``, ``w_up`` by column, ``w_down`` by row: the
reference's ``_MOE_3D`` rule); its routing and dispatch run replicated:

  * :meth:`TensorParallel.enter` (identity forward, all-reduce of the
    gradient backward) where the replicated activations enter a split
    product;
  * :meth:`TensorParallel.exit` (all-reduce forward, identity backward)
    on the partial sums that leave ``wo`` and ``w_down`` (the MoE's
    gate-weighted combine of its experts' partial outputs);
  * :meth:`TensorParallel.embed`, the vocabulary-split lookup: each rank
    looks up the tokens in its rows, zeros the rest, and the sum is
    all-reduced;
  * :meth:`TensorParallel.gather_last`, the logits' column blocks
    gathered, where a caller wants them whole (serving);
  * :meth:`TensorParallel.vocab_xent`, the training loss on the logits'
    column blocks as they are (the vocabulary-parallel cross-entropy of
    Megatron: the max, the sum of exponentials and the gold logit
    all-reduced, the backward local), so no rank holds the whole
    vocabulary's logits.

A block under tensor parallelism carries :meth:`local_config`, the
configuration of its share (``n_heads``, ``n_kv_heads`` and ``d_ff``
divided by the group's size), so the attention and FFN code runs as is.
Where the kv heads are fewer than the group's ranks (qwen3-8b's 8 against
a 'model' axis of 16), the query heads still split, ``n_heads / size`` a
rank, and each rank holds the one kv head its queries read: ``kv_share =
size / n_kv_heads`` consecutive ranks (``kv_group``) share a head, each
storing ``1 / kv_share`` of its columns as ``Shard`` on 'model' lays them
out.  :meth:`gather_kv` all-gathers a head's columns within its
``kv_group`` before the step, and :meth:`reduce_kv` sums the gradient
over the group, whose ranks each saw only their own queries' share, and
keeps this rank's columns.
The replicated weights applied inside the split (qwen3's ``q_norm`` and
``k_norm`` head by head, the MoE router whose gates weight each rank's
partial expert outputs; :data:`PARTIAL_GRADS`) see only this rank's
share, so their gradients are partial sums that the trainer all-reduces
over the group.  The vlm's patch embeddings enter replicated before the
split lookup's tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F


#: Replicated weights used on each rank's own share: their gradients are
#: summed over the 'model' group.
PARTIAL_GRADS = ("q_norm", "k_norm", "w_router")

#: The kv projections, whose heads ``kv_share`` ranks may share.
KV_WEIGHTS = ("wk", "wv")


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_cat(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """``t`` of every rank of ``group`` (``size`` ranks), concatenated on
    ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        return gather_cat(x, -1, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), \
            None, None, None


class _VocabXent(torch.autograd.Function):
    """The mean cross-entropy of logits split by vocabulary: the max, the
    sum of exponentials and the gold logit all-reduced over the group;
    the backward is local (softmax minus the one-hot, on this rank's
    columns)."""

    @staticmethod
    def forward(ctx, logits, labels, group, rank):
        logits = logits.float()
        n = logits.shape[-1]
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        z = e.sum(dim=-1)
        dist.all_reduce(z, group=group)
        local = labels - rank * n
        hit = torch.arange(n, device=logits.device) == local[..., None]
        gold = torch.where(hit, logits, 0.0).sum(dim=-1)
        dist.all_reduce(gold, group=group)
        nll = torch.log(z) + m - gold
        ctx.save_for_backward(e.div_(z[..., None]), local)
        ctx.count = nll.numel()
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        p, local = ctx.saved_tensors
        hit = torch.arange(p.shape[-1], device=p.device) == local[..., None]
        return (p - hit.to(p.dtype)) * (g / ctx.count), None, None, None


@dataclass(frozen=True)
class TensorParallel:
    """One rank's place in a 'model' group: the group, its rank in it and
    the group's size."""

    group: object
    rank: int
    size: int
    kv_group: object = None     # the ranks sharing this rank's kv head
    kv_share: int = 1           # size // n_kv_heads where that is > 1

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(x, self.group)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self.group, self.rank, self.size)

    def vocab_xent(self, logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
        """``layers.softmax_xent`` (the mean) of logits split by
        vocabulary, ``logits`` this rank's columns ``rank * n .. (rank + 1)
        * n - 1``: the loss without gathering the logits."""
        return _VocabXent.apply(logits, labels, self.group, self.rank)

    def embed(self, tokens: torch.Tensor, rows: torch.Tensor
              ) -> torch.Tensor:
        """The lookup of ``tokens`` in a table split by row: ``rows`` is
        this rank's block, table rows ``rank * n .. (rank + 1) * n - 1``."""
        n = rows.shape[0]
        local = tokens - self.rank * n
        inside = (local >= 0) & (local < n)
        x = F.embedding(local.clamp(0, n - 1), rows) * \
            inside[..., None].to(rows.dtype)
        return self.exit(x)

    def local_config(self, cfg):
        """The configuration of one rank's share of a block (one kv head
        where ``kv_share`` ranks share each)."""
        return cfg.with_(n_heads=cfg.n_heads // self.size,
                         n_kv_heads=cfg.n_kv_heads * self.kv_share
                         // self.size,
                         d_ff=cfg.d_ff // self.size,
                         head_dim=cfg.resolved_head_dim)

    def gather_kv(self, cols: torch.Tensor) -> torch.Tensor:
        """(D, hd / kv_share), this rank's stored columns of ``wk`` or
        ``wv`` -> (D, hd), its kv head's, gathered in ``kv_group``."""
        if self.kv_share == 1:
            return cols
        return gather_cat(cols, -1, self.kv_group, self.kv_share)

    def reduce_kv(self, g: torch.Tensor) -> torch.Tensor:
        """A kv head's gradient (D, hd), this rank's queries' share ->
        the sum over ``kv_group``, this rank's stored columns of it."""
        if self.kv_share == 1:
            return g
        g = g.contiguous()
        dist.all_reduce(g, group=self.kv_group)
        return g.chunk(self.kv_share, dim=-1)[
            self.rank % self.kv_share].contiguous()

    @staticmethod
    def kv_share_of(cfg, size: int) -> int:
        """How many ranks of a group of ``size`` share each kv head: 1
        where the kv heads split into ``size`` whole blocks, ``size /
        n_kv_heads`` where that divides, else 0 (no split)."""
        if cfg.n_kv_heads % size == 0:
            return 1
        if size % cfg.n_kv_heads == 0 and \
                cfg.resolved_head_dim % (size // cfg.n_kv_heads) == 0:
            return size // cfg.n_kv_heads
        return 0

    @staticmethod
    def fits(cfg, size: int) -> bool:
        """Whether ``cfg`` runs split over a group of ``size``: a dense
        (SwiGLU, without the logic FFN), vlm or moe model whose query
        heads, FFN units (each expert's, for moe) and vocabulary split
        into ``size`` whole blocks, and whose kv heads split too or are
        shared by ``size / n_kv_heads`` ranks each (:meth:`kv_share_of`).
        Every other family runs gathered: the ssm and the hybrid's
        recurrent blocks, and the audio GeLU MLP, have no split here."""
        if cfg.family not in ("dense", "vlm", "moe") or cfg.logic_mlp:
            return False
        return all(n % size == 0 for n in (cfg.n_heads, cfg.d_ff,
                                           cfg.padded_vocab)) and \
            TensorParallel.kv_share_of(cfg, size) > 0
