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
    gathered, so the loss runs on the whole vocabulary as without a
    split.

A block under tensor parallelism carries :meth:`local_config`, the
configuration of its share (``n_heads``, ``n_kv_heads`` and ``d_ff``
divided by the group's size), so the attention and FFN code runs as is.
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


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), \
            None, None, None


@dataclass(frozen=True)
class TensorParallel:
    """One rank's place in a 'model' group: the group, its rank in it and
    the group's size."""

    group: object
    rank: int
    size: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(x, self.group)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self.group, self.rank, self.size)

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
        """The configuration of one rank's share of a block."""
        return cfg.with_(n_heads=cfg.n_heads // self.size,
                         n_kv_heads=cfg.n_kv_heads // self.size,
                         d_ff=cfg.d_ff // self.size,
                         head_dim=cfg.resolved_head_dim)

    @staticmethod
    def fits(cfg, size: int) -> bool:
        """Whether ``cfg`` runs split over a group of ``size``: a dense
        (SwiGLU, without the logic FFN), vlm or moe model whose heads, FFN
        units (each expert's, for moe) and vocabulary split into ``size``
        whole blocks.  Every other family runs gathered: the ssm and the
        hybrid's recurrent blocks, and the audio GeLU MLP, have no split
        here."""
        if cfg.family not in ("dense", "vlm", "moe") or cfg.logic_mlp:
            return False
        return all(n % size == 0 for n in (cfg.n_heads, cfg.n_kv_heads,
                                           cfg.d_ff, cfg.padded_vocab))
