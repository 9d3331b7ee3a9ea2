"""Megatron tensor parallelism over a mesh's 'model' dim, with the
sequence-parallel residual stream, for the training and serving of every
family but the ssm (and the logic FFN).

The reference leaves the split over 'model' to XLA's SPMD partitioner,
which follows ``train/sharding.py``'s rules for the weights and the
``constrain`` annotations of the model code for the activations.  PyTorch
runs eagerly, so the split is written out here [Shoeybi et al. 2019,
arXiv:1909.08053; Korthikanti et al. 2022, arXiv:2205.05198]: each rank of
a 'model' group holds a contiguous block of the query and key/value heads
(``wq``, ``wk``, ``wv`` by column, ``wo`` by row), of the FFN's hidden
units (SwiGLU's ``w_gate``, ``w_up`` by column and ``w_down`` by row; the
audio GeLU MLP's ``w_in`` by column and ``w_out`` by row), of the RG-LRU
block's ``d_rnn`` channels (``gate_proj``, ``rnn_proj``, ``conv_w``,
``w_a``, ``w_x`` by column, ``b_a``, ``b_x``, ``lam`` on ``d_rnn``,
``out_proj`` by row) and of the vocabulary (``embed`` by row,
``lm_head``/``head`` by column) -- exactly the blocks ``Shard`` on 'model'
gives them -- and a block runs its own heads, units and channels.  A MoE
block's experts split the same way, each rank holding the same F-block of
every expert (the reference's ``_MOE_3D`` rule); its routing and dispatch
run on the whole sequence.

**The residual stream.**  With ``cfg.seq_parallel`` (every config but
mamba2's) the stream between blocks is this rank's block of the sequence,
as the reference's ``constrain(x, "dp", "model", None)`` lays it out
(Megatron-SP): the embedding leaves as the block (the vocabulary-split
lookup's partial sums reduce-scattered by sequence, :meth:`embed`; the
audio frontend's output split, :meth:`split`), the norms run on the
block, and

  * :meth:`TensorParallel.enter` is an all-gather by sequence (a
    reduce-scatter of the gradient backward) where the stream enters a
    split product;
  * :meth:`TensorParallel.exit` is a reduce-scatter by sequence (an
    all-gather backward) of the partial sums that leave ``wo``,
    ``w_down``, ``w_out`` and ``out_proj`` (the MoE's gate-weighted
    combine of its experts' partial outputs).

A sequence that does not divide the group (decode's one token, an odd
prompt) stays whole on every rank, as the reference's ``_resolve``
replicates a dim that does not divide: ``enter`` is then the identity (an
all-reduce of the gradient backward) and ``exit`` an all-reduce (the
identity backward).  :meth:`TensorParallel.splits` decides it from the
sequence's length.

**Attention.**  Where the query heads split into whole blocks and the kv
heads split too or are shared (:meth:`heads_split`), each rank runs its
heads.  Where the kv heads are fewer than the ranks (qwen3-8b's 8 against
16) ``kv_share = size / n_kv_heads`` consecutive ranks (``kv_group``)
share a head, each storing ``1 / kv_share`` of its columns as ``Shard``
lays them out: :meth:`gather_kv` all-gathers a head's columns before the
step, and :meth:`reduce_kv` sums the gradient over the group, whose ranks
each saw only their own queries' share, and keeps this rank's columns.
Where the query heads do not divide the group (minicpm-2b's 36 and
recurrentgemma-2b's 10 against 16), attention runs sequence parallel
(``seq_attn``), the reference's ``_constrain_qkv``: the attention weights
are whole on every rank, each rank projects its own block of the sequence,
the keys and values are all-gathered by sequence, the scores are (rows, H,
S / size, S), masked by position, and ``wo`` gives this rank's block of
the stream with no collective.  Without a split sequence the attention
then runs whole on every rank.

**The RG-LRU block.**  The temporal conv and the scan are per channel,
so they run exactly on the rank's ``d_rnn`` block; the gates read the
whole width (``w_a``, ``w_x`` are split by column), so the conv's output
is all-gathered along ``d_rnn`` (:meth:`gather`, a reduce-scatter of the
gradient backward) before them.

Around these:

  * :meth:`TensorParallel.embed`, the vocabulary-split lookup: each rank
    looks up the tokens in its rows, zeros the rest, and the sum leaves
    through :meth:`exit` (reduce-scattered by sequence where the stream
    splits);
  * :meth:`TensorParallel.gather_last`, the logits' column blocks
    gathered, where a caller wants them whole (serving);
  * :meth:`TensorParallel.vocab_xent`, the training loss on the logits'
    column blocks as they are (the vocabulary-parallel cross-entropy of
    Megatron: the max, the sum of exponentials and the gold logit
    all-reduced, the backward local), so no rank holds the whole
    vocabulary's logits.

A block under tensor parallelism carries :meth:`local_config`, the
configuration of its share (``n_heads`` and ``n_kv_heads`` divided by the
group's size where the heads split, ``d_ff`` always), so the attention
and FFN code runs as is.  Replicated weights used on this rank's share
see only that share, so their gradients are partial sums that the trainer
all-reduces over the group (:meth:`partial_grads`): qwen3's ``q_norm`` and
``k_norm`` where the heads split, the MoE router whose gates weight each
rank's partial expert outputs, and, with the sequence split, the
residual's norms and the sequence-parallel attention's weights.  The
vlm's patch embeddings enter replicated before the split lookup's tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F


#: The kv projections, whose heads ``kv_share`` ranks may share.
KV_WEIGHTS = ("wk", "wv")

#: The attention's weights, whole on every rank under ``seq_attn``.
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")

#: The norms of the residual stream, which see this rank's block of the
#: sequence where it is split.
NORMS = ("attn_norm", "mlp_norm", "final_norm")


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


def scatter_sum(t: torch.Tensor, dim: int, group, size: int
                ) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's block of it on ``dim``
    (a reduce-scatter)."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    # the list form: gloo's tensor form copies its result once more
    dist.reduce_scatter(out, list(x.chunk(size)), group=group)
    return out.movedim(0, dim).contiguous()


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        return gather_cat(x, -1, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), \
            None, None, None


class _Gather(torch.autograd.Function):
    """All-gather on ``dim``; the gradient, a partial sum on each rank,
    reduce-scattered back."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum(g, ctx.dim, ctx.group, ctx.size), \
            None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter on ``dim``; the gradient all-gathered back."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return scatter_sum(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.dim, ctx.group, ctx.size), \
            None, None, None


class _Split(torch.autograd.Function):
    """This rank's block on ``dim`` of a tensor every rank holds whole;
    the gradient all-gathered back."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return x.chunk(size, dim=dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.dim, ctx.group, ctx.size), \
            None, None, None, None


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
    """One rank's place in a 'model' group: the group, its rank in it, the
    group's size, whether the residual stream is split by sequence
    (``seq``) and whether attention runs sequence parallel with its
    weights whole (``seq_attn``; else each rank runs its heads)."""

    group: object
    rank: int
    size: int
    kv_group: object = None     # the ranks sharing this rank's kv head
    kv_share: int = 1           # size // n_kv_heads where that is > 1
    seq: bool = False
    seq_attn: bool = False

    def splits(self, s: int) -> bool:
        """Whether a sequence of ``s`` positions runs split over the
        group: with ``seq`` and where ``s`` divides."""
        return self.seq and s % self.size == 0

    def enter(self, x: torch.Tensor, seq: bool = False) -> torch.Tensor:
        """The residual stream -> the input of a split product: the
        identity (the gradient all-reduced), or with ``seq`` (the stream
        is this rank's block of the sequence) the all-gather by
        sequence."""
        if seq:
            return _Gather.apply(x, 1, self.group, self.size)
        return _Enter.apply(x, self.group)

    def exit(self, x: torch.Tensor, seq: bool = False) -> torch.Tensor:
        """A split product's partial sums -> the residual stream: their
        all-reduce, or with ``seq`` their reduce-scatter by sequence."""
        if seq:
            return _Scatter.apply(x, 1, self.group, self.size)
        return _Exit.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block, concatenated on ``dim``; the gradient (a
        partial sum on each rank) reduce-scattered back."""
        return _Gather.apply(x, dim, self.group, self.size)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block on ``dim`` of a tensor every rank holds
        whole; the gradient all-gathered back."""
        return _Split.apply(x, dim, self.group, self.rank, self.size)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self.group, self.rank, self.size)

    def vocab_xent(self, logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
        """``layers.softmax_xent`` (the mean) of logits split by
        vocabulary, ``logits`` this rank's columns ``rank * n .. (rank + 1)
        * n - 1``: the loss without gathering the logits."""
        return _VocabXent.apply(logits, labels, self.group, self.rank)

    def embed(self, tokens: torch.Tensor, rows: torch.Tensor,
              seq: bool = False, prefix: torch.Tensor | None = None
              ) -> torch.Tensor:
        """The lookup of ``tokens`` in a table split by row: ``rows`` is
        this rank's block, table rows ``rank * n .. (rank + 1) * n - 1``.
        Each rank's rows are partial sums (zero where another rank holds
        the token), which :meth:`exit` sums: with ``seq`` by a
        reduce-scatter that leaves this rank's block of the sequence.
        ``prefix`` (B, P, D), which every rank holds whole (the vlm's
        patch embeddings), goes before the tokens, entering the sum once
        (rank 0's)."""
        n = rows.shape[0]
        local = tokens - self.rank * n
        inside = (local >= 0) & (local < n)
        x = F.embedding(local.clamp(0, n - 1), rows) * \
            inside[..., None].to(rows.dtype)
        if prefix is not None:
            x = torch.cat([prefix if self.rank == 0 else
                           torch.zeros_like(prefix), x], dim=1)
        return self.exit(x, seq)

    def local_config(self, cfg, kind: str = "dense"):
        """The configuration of one rank's share of a block of ``kind``:
        ``d_ff`` divided by the group's size, and an attention block's
        heads too where they split (one kv head where ``kv_share`` ranks
        share each).  A recurrent block's ``d_rnn`` block is its weights'
        and its heads are read nowhere, so they stay whole."""
        if self.seq_attn or kind == "rec":
            return cfg.with_(d_ff=cfg.d_ff // self.size,
                             head_dim=cfg.resolved_head_dim)
        return cfg.with_(n_heads=cfg.n_heads // self.size,
                         n_kv_heads=cfg.n_kv_heads * self.kv_share
                         // self.size,
                         d_ff=cfg.d_ff // self.size,
                         head_dim=cfg.resolved_head_dim)

    def partial_grads(self, seq: bool) -> frozenset:
        """The replicated weights (by leaf name) used on this rank's share
        of the work, whose gradients are partial sums over the group, for
        a step whose residual stream was split by sequence (``seq``) or
        not: the MoE router always; ``q_norm`` and ``k_norm`` where the
        heads split; with ``seq``, the residual's norms and, under
        ``seq_attn``, the attention's weights."""
        names = {"w_router"}
        if not self.seq_attn or seq:
            names |= {"q_norm", "k_norm"}
        if seq:
            names |= set(NORMS)
            if self.seq_attn:
                names |= set(ATTN_WEIGHTS)
        return frozenset(names)

    def gather_kv(self, cols: torch.Tensor) -> torch.Tensor:
        """(D, hd / kv_share), this rank's stored columns of ``wk`` or
        ``wv`` -> (D, hd), its kv head's, gathered in ``kv_group``."""
        if self.kv_share == 1:
            return cols
        return gather_cat(cols, -1, self.kv_group, self.kv_share)

    def reduce_kv(self, g: torch.Tensor) -> torch.Tensor:
        """A kv head's gradient (rows, hd), this rank's queries' share ->
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
    def heads_split(cfg, size: int) -> bool:
        """Whether attention splits by heads over a group of ``size``:
        the query heads into whole blocks, the kv heads split or shared
        (:meth:`kv_share_of`).  Else it runs sequence parallel."""
        return cfg.n_heads % size == 0 and \
            TensorParallel.kv_share_of(cfg, size) > 0

    @staticmethod
    def fits(cfg, size: int) -> bool:
        """Whether ``cfg`` runs split over a group of ``size``: a dense
        (SwiGLU, without the logic FFN), vlm, moe, hybrid or audio model
        whose FFN units (each expert's, for moe), vocabulary and, for the
        hybrid, RG-LRU width split into whole blocks.  Attention splits
        either way (by heads or by sequence, :meth:`heads_split`).  The
        ssm runs purely data parallel (``tensor_parallel=False``)."""
        if cfg.family not in ("dense", "vlm", "moe", "hybrid", "audio") \
                or cfg.logic_mlp:
            return False
        widths = [cfg.d_ff, cfg.padded_vocab]
        if cfg.family == "hybrid":
            widths.append(cfg.n_heads * cfg.resolved_head_dim)   # d_rnn
        return all(n % size == 0 for n in widths)
