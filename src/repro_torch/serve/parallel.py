"""Sharded inference: prefill and decode on a DeviceMesh, each rank its
rows of the batch and its block of the decode cache.

The reference jits ``prefill`` and ``decode_step`` with
``train/sharding.py``'s shardings (``param_shardings``, with
``decode=True`` for the decode step, and ``cache_shardings``) and lets
XLA place the collectives.  Here they are explicit.  Each rank

  * holds its blocks of the parameters (a ``train.parallel.ShardedModel``;
    the decode layout splits the embedding by ``d_model`` over 'model')
    and gathers each layer's when the layer runs (the embedding, final
    norm and head where the step reaches them), dropping them after, so
    no copy of the whole share stays between layers or calls: over 'pod'
    and 'data', and over 'model' only what the model runs whole
    (``train.parallel.model_parallel``: every family but the ssm runs
    tensor parallel, each rank its FFN units, RG-LRU channels and
    vocabulary, and its query heads where they divide 'model', ranks
    sharing a kv head where the kv heads are fewer than the ranks; where
    the heads do not divide, the attention weights are whole);
  * runs its rows of the batch (``train.parallel.batch_rows``);
  * holds its block of the decode cache as ``cache_placements`` lays it
    out: rows over the batch axes and, over 'model', the kv heads where
    they divide it, else the cache's sequence; the SSM state's heads and
    the RG-LRU state's width.

Prefill and encode run the training layout (``models/tensor_parallel.py``)
through ``serve.engine.prefill``'s loop and the model's forward: the
residual stream split by sequence where the prompt divides 'model',
sequence-parallel attention where the heads do not, the TP splits of the
hybrid's recurrent blocks and the audio GeLU MLP.  Each rank keeps its
block of the cache the prompt leaves, and its block of the logits'
vocabulary, as the reference's output sharding leaves them.

Decode attention runs over the cache block the rank holds.  Where the
block is a run of the sequence, the rank scores every head over its
positions, and the softmax's max, its sum and the weighted values are
all-reduced over 'model' (the reference writes its decode softmax with an
explicit max and sum so that XLA can do the same); only the rank whose
run holds the new token's slot writes it.  Where the model runs its
heads split, the queries and the new token's keys and values are first
gathered over 'model' (one token's, a few KB a row), and each rank keeps
its own heads' output for its rows of ``wo``; where the attention
weights are whole (minicpm-2b, the hybrid's attention), every rank
projects every head and applies the whole ``wo``.  The FFN and the
vocabulary run split.  The hybrid's recurrent blocks run on the ``d_rnn``
block of ``rec_h`` and ``rec_conv`` the rank holds; the ssm's states,
which the cache splits over 'model' while the model runs them whole, are
gathered before their layer and split after.  On a mesh whose dims have
one rank each nothing moves, and every step is the one-device step's
arithmetic.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.tensor_parallel import gather_cat
from repro_torch.serve.engine import (DecodeCache, _rec_block_step,
                                      _ssm_block_step, decode_cache_shapes,
                                      prefill)
from repro_torch.models.transformer import Transformer
from repro_torch.train.parallel import ShardedModel, batch_rows
from repro_torch.train.sharding import cache_placements

class ShardedServer:
    """``model`` (built whole on every rank from the same seed) sharded on
    ``mesh`` to serve a ``context`` of tokens: :meth:`prefill` and
    :meth:`encode` in the training layout, :meth:`decode_step` with
    ``decode=True`` (the reference's two layouts).  Each call takes this
    rank's rows (:meth:`rows`) and, for decode, its cache block
    (:meth:`init_cache`, or what :meth:`prefill` returns)."""

    def __init__(self, model: Transformer, mesh, *, decode: bool,
                 context: int):
        self.sm = ShardedModel(model, mesh, decode=decode)
        self.model, self.cfg, self.mesh = model, model.cfg, mesh
        self.context = context
        self.tp = self.sm.tp
        names = mesh.mesh_dim_names
        self.size = mesh.shape[names.index("model")] \
            if "model" in names else 1
        self.group = mesh.get_group("model") if self.size > 1 else None
        self.rank = mesh.get_local_rank("model") if self.size > 1 else 0
        # each cache field's tensor dim split over 'model' (the batch does
        # not change it)
        self.splits = {} if model.cfg.is_encoder else {
            k: dim for k, (_, _, dim) in self.cache_layout(1).items()}

    @property
    def device(self) -> torch.device:
        return self.model.device

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        return batch_rows(self.mesh, batch)[0]

    # ---- the cache's layout ----
    def cache_layout(self, batch: int) -> dict:
        """Each cache field's (this rank's block's shape, dtype, the
        tensor dim split over 'model' or None), for a global batch."""
        shapes = decode_cache_shapes(self.cfg, batch, self.context)
        meta = DecodeCache(**{k: torch.empty(s, dtype=dt, device="meta")
                              for k, (s, dt) in shapes.items()})
        pls = cache_placements(self.cfg, self.mesh, meta)._asdict()
        names = self.mesh.mesh_dim_names
        out = {}
        for k, (shape, dt) in shapes.items():
            pl = pls[k]
            dim = None
            if self.size > 1:
                p = pl[names.index("model")]
                dim = p.dim if p.is_shard() else None
            local = list(shape)
            for p, n in zip(pl, self.mesh.shape):
                if p.is_shard():
                    local[p.dim] //= n
            out[k] = (tuple(local), dt, dim)
        return out

    def init_cache(self, batch: int) -> DecodeCache:
        """This rank's block of an empty cache (``init_decode_cache``'s
        for the global batch and the context)."""
        return DecodeCache(**{
            k: torch.zeros(local, dtype=dt, device=self.device)
            for k, (local, dt, _) in self.cache_layout(batch).items()})

    def _block(self, field: str, t: torch.Tensor) -> torch.Tensor:
        """A layer's slice of a cache field, whole over 'model' -> this
        rank's block of it."""
        dim = self.splits[field]
        if dim is None:
            return t.contiguous()
        return t.chunk(self.size, dim=dim - 1)[self.rank].contiguous()

    def _whole(self, field: str, t: torch.Tensor) -> torch.Tensor:
        """A layer's block of a cache field -> whole over 'model'."""
        dim = self.splits[field]
        if dim is None:
            return t
        return gather_cat(t, dim - 1, self.group, self.size)

    def _gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        return gather_cat(t, 2, self.group, self.size)

    def _ran_heads(self) -> bool:
        """Whether the model's attention runs this rank's heads alone."""
        return self.tp is not None and not self.tp.seq_attn

    def _kv_block(self, t: torch.Tensor) -> torch.Tensor:
        """A layer's keys or values (B, C, heads the module ran, hd) ->
        this rank's cache block of them."""
        dim = self.splits["kv_k"]
        if self._ran_heads():
            if dim == 3:
                return t.contiguous()     # the module's heads are the block
            t = self._gather_heads(t)[:, :, ::self.tp.kv_share]
        return self._block("kv_k", t)

    def _keep(self, field: str, blk, t: torch.Tensor) -> torch.Tensor:
        """A layer's cache tensor from prefill -> this rank's block of it
        (the state itself where a recurrent block ran its ``d_rnn``
        block)."""
        if field in ("kv_k", "kv_v"):
            return self._kv_block(t)
        if blk.tp is not None:
            return t.contiguous()
        return self._block(field, t)

    # ---- prefill ----
    @torch.inference_mode()
    def prefill(self, tokens, *, vision=None
                ) -> tuple[torch.Tensor, DecodeCache]:
        """``serve.engine.prefill`` of this rank's rows ``tokens`` (after
        their ``vision`` for vlm): (their logits, this rank's cache
        block).  Under tensor parallelism the logits are this rank's
        block of the vocabulary, as the reference's prefill returns them
        (sharded over 'model')."""
        return prefill(self.model, tokens, self.context, vision=vision,
                       keep=self._keep)

    @torch.inference_mode()
    def encode(self, frames) -> torch.Tensor:
        """An encoder's forward (audio: the prefill cell) of this rank's
        rows of ``frames``; the logits split as :meth:`prefill`'s."""
        return self.model(frames=frames, gather=False)

    # ---- decode ----
    @torch.inference_mode()
    def decode_step(self, tokens, cache: DecodeCache
                    ) -> tuple[torch.Tensor, DecodeCache]:
        """``serve.engine.decode_step`` of this rank's rows ``tokens`` (B,
        1) on its cache block, written in place: (their logits, the cache
        with ``length + 1``)."""
        model, cfg = self.model, self.cfg
        x = model.lookup(tokens)
        ia = iss = irec = 0
        for blk in model.blocks:
            if blk.kind == "ssm":
                x = self._step_states(cache, "ssm_state", "conv_carry", iss,
                                      _ssm_block_step, blk, x)
                iss += 1
            elif blk.kind == "rec":
                x = self._step_states(cache, "rec_h", "rec_conv", irec,
                                      _rec_block_step, blk, x)
                irec += 1
            else:
                x = self._attn_block(blk, x, attn.KVCache(
                    k=cache.kv_k[ia], v=cache.kv_v[ia], length=cache.length))
                ia += 1
        x = rms_norm(x, model.weight("final_norm"))
        return model.lm_logits(x), cache._replace(length=cache.length + 1)

    def _step_states(self, cache, state: str, conv: str, i: int, step,
                     blk, x) -> torch.Tensor:
        """A recurrent block's ``step`` (``engine``'s): on this rank's
        blocks of its layer's states where the block runs split, else on
        the whole states, this rank keeping its blocks of the new ones."""
        s_all, c_all = getattr(cache, state), getattr(cache, conv)
        if blk.tp is not None:
            x, s_all[i], c_all[i] = step(blk, x, self.cfg, s_all[i],
                                         c_all[i])
            return x
        x, s, c = step(blk, x, self.cfg, self._whole(state, s_all[i]),
                       self._whole(conv, c_all[i]))
        s_all[i] = self._block(state, s)
        c_all[i] = self._block(conv, c)
        return x

    def _attn_block(self, blk, x, kv: attn.KVCache) -> torch.Tensor:
        p = blk.params()
        h = rms_norm(x, p["attn_norm"])
        if self._ran_heads():
            x = x + blk._tp_out(self._attend(blk, p, blk._tp_in(h), kv))
        else:       # no split, or the attention weights whole
            x = x + self._attend(blk, p, h, kv)
        h = rms_norm(x, p["mlp_norm"])
        return x + blk.mlp(p, h)

    def _attend(self, blk, p: dict, h: torch.Tensor, kv: attn.KVCache
                ) -> torch.Tensor:
        """``attention_decode`` on this rank's cache block: its heads, or
        every head over its run of the sequence (the softmax reduced over
        'model'); returns the output of the module's heads through its
        rows of ``wo`` (all of them where the weights are whole)."""
        full, b = self.cfg, h.shape[0]
        hd = full.resolved_head_dim
        pos = kv.length
        q, k, v = attn._qkv(p, h, blk.cfg)
        if not full.is_encoder:
            positions = torch.full((b, 1), pos, dtype=torch.int32,
                                   device=h.device)
            q = apply_rope(q, positions, full.rope_theta)
            k = apply_rope(k, positions, full.rope_theta)
        dim = self.splits["kv_k"]
        heads, seq = dim == 3, dim == 2
        ran_heads = self._ran_heads()
        if heads and not ran_heads:
            # the module ran every head; this rank's cache holds a block
            hq, hk = full.n_heads // self.size, full.n_kv_heads // self.size
            q = q[:, :, self.rank * hq:(self.rank + 1) * hq]
            k = k[:, :, self.rank * hk:(self.rank + 1) * hk]
            v = v[:, :, self.rank * hk:(self.rank + 1) * hk]
        elif not heads and ran_heads:
            q = self._gather_heads(q)
            k = self._gather_heads(k)[:, :, ::self.tp.kv_share]
            v = self._gather_heads(v)[:, :, ::self.tp.kv_share]
        n = kv.k.shape[1]
        cap = n * self.size if seq else n
        slot = pos % cap
        owner, local = divmod(slot, n) if seq else (self.rank, slot)
        if owner == self.rank:
            kv.k[:, local] = k[:, 0].to(kv.k.dtype)
            kv.v[:, local] = v[:, 0].to(kv.v.dtype)
        t = torch.arange(n, device=h.device) + (self.rank * n if seq else 0)
        live = torch.ones(n, dtype=torch.bool, device=h.device) \
            if pos + 1 >= cap else t <= slot
        hk = kv.k.shape[2]
        qg = q.reshape(b, 1, hk, q.shape[2] // hk, hd).float() * \
            (hd ** -0.5)
        scores = torch.einsum("bshgd,bthd->bhgst", qg, kv.k.float())
        scores = torch.where(live, scores, attn.NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        if seq:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        e = torch.exp(scores - m)
        z = e.sum(dim=-1, keepdim=True)
        if seq:
            dist.all_reduce(z, group=self.group)
        w = (e / z).to(h.dtype)
        out = torch.einsum("bhgst,bthd->bshgd", w, kv.v)
        if seq:
            dist.all_reduce(out, group=self.group)
        out = out.reshape(b, 1, -1, hd)
        if heads and not ran_heads:
            out = self._gather_heads(out)
        elif not heads and ran_heads:
            hq = blk.cfg.n_heads
            out = out[:, :, self.tp.rank * hq:(self.tp.rank + 1) * hq]
        return out.reshape(b, 1, -1) @ p["wo"].to(h.dtype)
