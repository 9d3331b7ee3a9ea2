"""Model assembly for every architecture family: parameters, forward,
logits and the training loss.

Port of ``src/repro/models/transformer.py`` as a :class:`Transformer`
``nn.Module`` with an ``nn.ModuleList`` of per-layer :class:`Block`s.
Families: dense (llama/qwen-style GQA + SwiGLU, qk-norm, tied embeddings
for minicpm), moe (Mixtral / Grok top-2, ``models/moe.py``), ssm (Mamba-2
/ SSD, ``models/mamba2.py``), audio (encoder-only, a stub frontend:
``frames @ frontend_proj``), vlm (the LM backbone with stub patch
embeddings ``vision`` before the tokens) and hybrid (RecurrentGemma:
RG-LRU blocks, ``models/rglru.py``, and local attention on
``local_window``).  A block's kind (:func:`layer_kinds`: ``dense``,
``moe``, ``ssm`` or ``rec``) decides its parameters, which carry the
reference's names (``attn_norm``, ``wq``, ..., ``w_router``, ``in_proj``,
``gate_proj``, ...), so ``block.params()`` is the per-layer dict the layer
functions take, and the state dict is the reference's tree with its
layer stacks (``blocks``, the hybrid's ``groups`` + ``tail``, or
``layers``) split per layer (``convert.transformer_params_from_reference``).

With ``cfg.logic_mlp`` (dense family only) a block's FFN is the binarized
MLP of ``models/logic_mlp.py`` (``w_in``, ``b_in``, ``w_out``): it runs
``binary_ffn`` until the block is given a compiled program
(``block.program``), and ``logic_ffn_apply`` (K1 on the card) after.

The forward records autograd only where grad is enabled and the
parameters ask for it: the model is built with ``requires_grad`` off, the
trainer turns it on, and the serving paths run under
``torch.inference_mode()``.  ``cfg.remat`` (the reference's
``_maybe_remat``) applies while grad is enabled: ``"full"`` checkpoints
each block of every kind (``torch.utils.checkpoint``, non-reentrant),
``"dots"`` saves only the matrix products' outputs and recomputes the
rest, ``"none"`` is the plain loop.  The reference remats the hybrid per
pattern group (its scan body); the port remats per block, since its loop
runs block by block: a recomputation repeats the forward's arithmetic
exactly, so either gives the same numbers, and per block holds one
block's activations at a time instead of a group's.  :func:`train_loss`
is the reference's loss: next-token, over the text only for vlm, against
``labels`` for audio.

The reference's sharding annotations are here at the same places
(``models/pspec_utils.constrain``: the residual stream between blocks,
sequence-sharded over 'model' with ``cfg.seq_parallel``, and the logits);
they redistribute DTensors under an active mesh and change nothing else.
Under the sharded trainer a dense, vlm or moe model runs its split
products through :meth:`Transformer.set_tensor_parallel`
(``models/tensor_parallel.py``); without it no collective runs.  The
reference's layer and group scans are a Python loop over the blocks.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.logic_dsp.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe, rglru
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (DTYPES, gelu_mlp, normal_init,
                                       ones_init, rms_norm, softmax_xent,
                                       swiglu, zeros_init)
from repro_torch.models.logic_mlp import binary_ffn, logic_ffn_apply
from repro_torch.models.pspec_utils import constrain


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


# ===========================================================================
# Parameter construction
# ===========================================================================

def _attn_params(cfg, d):
    hd = cfg.resolved_head_dim
    p = {
        "attn_norm": ("ones", (d,)),
        "wq": ("normal", (d, cfg.n_heads * hd)),
        "wk": ("normal", (d, cfg.n_kv_heads * hd)),
        "wv": ("normal", (d, cfg.n_kv_heads * hd)),
        "wo": ("normal", (cfg.n_heads * hd, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = ("ones", (hd,))
        p["k_norm"] = ("ones", (hd,))
    return p


def _mlp_params(cfg, d):
    if cfg.logic_mlp:
        return {"mlp_norm": ("ones", (d,)),
                "w_in": ("normal", (d, cfg.d_ff)),
                "b_in": ("zeros", (cfg.d_ff,)),
                "w_out": ("normal", (cfg.d_ff, d))}
    if cfg.family == "audio":
        return {"mlp_norm": ("ones", (d,)),
                "w_in": ("normal", (d, cfg.d_ff)),
                "w_out": ("normal", (cfg.d_ff, d))}
    return {"mlp_norm": ("ones", (d,)),
            "w_gate": ("normal", (d, cfg.d_ff)),
            "w_up": ("normal", (d, cfg.d_ff)),
            "w_down": ("normal", (cfg.d_ff, d))}


def _moe_params(cfg, d):
    e, f = cfg.n_experts, cfg.d_ff
    return {"mlp_norm": ("ones", (d,)),
            "w_router": ("normal", (d, e)),
            "w_gate": ("normal", (e, d, f)),
            "w_up": ("normal", (e, d, f)),
            "w_down": ("normal", (e, f, d))}


def _ssm_params(cfg, d):
    d_in, nh, p, n = mamba2.ssm_dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        "norm": ("ones", (d,)),
        "in_proj": ("normal", (d, 2 * d_in + 2 * n + nh)),
        "conv_w": ("normal", (cfg.ssm_conv_width, conv_ch)),
        "dt_bias": ("zeros", (nh,)),
        "a_log": ("zeros", (nh,)),
        "skip_d": ("ones", (nh,)),
        "out_norm": ("ones", (d_in,)),
        "out_proj": ("normal", (d_in, d)),
    }


def _rec_params(cfg, d):
    d_rnn = cfg.n_heads * cfg.resolved_head_dim
    return {
        "attn_norm": ("ones", (d,)),          # pre-norm of the mixing block
        "gate_proj": ("normal", (d, d_rnn)),
        "rnn_proj": ("normal", (d, d_rnn)),
        "conv_w": ("normal", (cfg.ssm_conv_width, d_rnn)),
        "w_a": ("normal", (d_rnn, d_rnn)),
        "b_a": ("zeros", (d_rnn,)),
        "w_x": ("normal", (d_rnn, d_rnn)),
        "b_x": ("zeros", (d_rnn,)),
        "lam": ("ones", (d_rnn,)),            # init_params: 4.0
        "out_proj": ("normal", (d_rnn, d)),
    }


def block_param_spec(cfg: ModelConfig, kind: str = "dense") -> dict:
    """One block's ``{name: (init_kind, shape)}`` for its kind."""
    d = cfg.d_model
    if kind == "ssm":
        return _ssm_params(cfg, d)
    if kind == "rec":
        return {**_rec_params(cfg, d), **_mlp_params(cfg, d)}
    if kind == "moe":
        return {**_attn_params(cfg, d), **_moe_params(cfg, d)}
    # dense / audio / vlm / hybrid-attn
    return {**_attn_params(cfg, d), **_mlp_params(cfg, d)}


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        # normalize: pattern "attn" entries are plain dense blocks
        return [("dense" if pat[i % len(pat)] == "attn" else
                 pat[i % len(pat)]) for i in range(cfg.n_layers)]
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    return ["dense"] * cfg.n_layers


def hybrid_grouping(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, n_tail) of the reference's scan over a heterogeneous
    pattern stack."""
    plen = len(cfg.block_pattern) or 1
    n_groups = cfg.n_layers // plen
    return n_groups, cfg.n_layers - n_groups * plen


def layer_window(cfg: ModelConfig, kind: str) -> int:
    """The attention window of a layer of this kind (0: full): the
    hybrid's attention layers attend over ``local_window``."""
    if cfg.family == "hybrid" and kind == "dense":
        return cfg.local_window
    return cfg.sliding_window


def param_spec(cfg: ModelConfig) -> dict:
    """The model's top-level ``{name: (init_kind, shape)}`` (blocks
    aside)."""
    d = cfg.d_model
    spec = {"final_norm": ("ones", (d,))}
    if cfg.family == "audio":
        spec["frontend_proj"] = ("normal", (cfg.frontend_dim, d))
        spec["head"] = ("normal", (d, cfg.padded_vocab))
        return spec
    spec["embed"] = ("normal", (cfg.padded_vocab, d))
    if not cfg.tie_embeddings:
        spec["lm_head"] = ("normal", (d, cfg.padded_vocab))
    return spec


_INITS = {"normal": normal_init, "zeros": zeros_init, "ones": ones_init}


def _register(module: nn.Module, spec: dict, dtype, device) -> None:
    module.init_kinds = {k: ik for k, (ik, _) in spec.items()}
    for name, (_, shape) in spec.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))


# ===========================================================================
# Mixing layers on pre-normed input (shared with serve/engine.py's prefill)
# ===========================================================================

def _ssm_mix(p, xz, cfg, conv_carry=None, init_state=None):
    """Core mamba2 mixing on pre-normed input. Returns (y, carry, state)."""
    b, s, _ = xz.shape
    d_in, nh, hp, n = mamba2.ssm_dims(cfg)
    zxbcdt = xz @ p["in_proj"].to(xz.dtype)
    # jnp.split takes split points, torch.split sizes
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [d_in, d_in, n, n, nh],
                                         dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out, new_carry = rglru.temporal_conv(
        {"conv_w": p["conv_w"]}, conv_in, cfg.ssm_conv_width, conv_carry)
    conv_out = F.silu(conv_out.float()).to(xz.dtype)
    xin, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xin.reshape(b, s, nh, hp)
    y, state = mamba2.ssd_chunked(xh, dt, p["a_log"], bmat, cmat,
                                  cfg.ssm_chunk, init_state)
    y = y + xh.float() * p["skip_d"].float()[None, None, :, None]
    y = y.reshape(b, s, d_in).to(xz.dtype)
    y = y * F.silu(z.float()).to(xz.dtype)
    y = rms_norm(y, p["out_norm"])
    return y @ p["out_proj"].to(xz.dtype), new_carry, state


def _rec_gate(p, h):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu((h @ p["gate_proj"].to(h.dtype)).float(),
                  approximate="tanh").to(h.dtype)


_LRU_KEYS = ("w_a", "b_a", "w_x", "b_x", "lam")


def _rec_mix(p, h, cfg, conv_carry=None, init_h=None):
    """Griffin recurrent mixing on pre-normed input. Returns (y, carry,
    final h)."""
    gate = _rec_gate(p, h)
    u = h @ p["rnn_proj"].to(h.dtype)
    u, new_carry = rglru.temporal_conv({"conv_w": p["conv_w"]}, u,
                                       cfg.ssm_conv_width, conv_carry)
    u, h_last = rglru.rglru_scan({k: p[k] for k in _LRU_KEYS}, u,
                                 cfg.rglru_c, init_h)
    y = (gate * u) @ p["out_proj"].to(h.dtype)
    return y, new_carry, h_last


class Block(nn.Module):
    """One layer of kind ``dense`` (pre-norm attention, then a pre-norm
    FFN: SwiGLU, the audio GeLU MLP, or the binarized / logic FFN with
    ``cfg.logic_mlp``), ``moe`` (attention, then the routed experts),
    ``ssm`` (the Mamba-2 mixer alone) or ``rec`` (the RG-LRU mixer, then
    SwiGLU)."""

    def __init__(self, cfg: ModelConfig, kind: str = "dense", device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.window = layer_window(cfg, kind)
        _register(self, block_param_spec(cfg, kind), _dtype(cfg), device)
        self.program = None         # the logic FFN's compiled program
        self.tp = None              # its TensorParallel share, if split

    def _tp_in(self, h):
        return h if self.tp is None else self.tp.enter(h)

    def _tp_out(self, y):
        return y if self.tp is None else self.tp.exit(y)

    def params(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def ffn(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        if self.kind == "moe":
            return moe.moe_forward(p, h, self.cfg)
        if self.cfg.family == "audio":
            return gelu_mlp(h, p["w_in"], p["w_out"])
        if not self.cfg.logic_mlp:
            return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        if self.program is None:
            return binary_ffn(p, h)
        return logic_ffn_apply(self.program, p, h)

    def forward(self, x, positions,
                ffn_inputs: list | None = None) -> torch.Tensor:
        p = self.params()
        if self.kind == "ssm":
            y, _, _ = _ssm_mix(p, rms_norm(x, p["norm"]), self.cfg)
            return x + y
        h = rms_norm(x, p["attn_norm"])
        if self.kind == "rec":
            x = x + _rec_mix(p, h, self.cfg)[0]
        else:
            x = x + self._tp_out(attn.attention_forward(
                p, self._tp_in(h), self.cfg, positions=positions,
                causal=not self.cfg.is_encoder, window=self.window))
        h = rms_norm(x, p["mlp_norm"])
        if ffn_inputs is not None:
            ffn_inputs.append(h)
        return x + self._tp_out(self.ffn(p, self._tp_in(h)))


class Transformer(nn.Module):
    """The model: ``embed`` (``frontend_proj`` for audio), ``blocks``,
    ``final_norm`` and the head (``lm_head``; ``head`` for audio; the
    embedding's transpose when tied), in ``cfg.param_dtype`` on ``device``
    (CUDA unless ``"cpu"``).  The parameters are allocated, not
    initialized: :func:`init_params` fills them from a generator, and
    ``load_state_dict`` from carried-across weights."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.logic_mlp and cfg.family != "dense":
            raise ValueError(f"{cfg.name}: logic_mlp swaps the dense "
                             f"family's FFN, not the {cfg.family} family's")
        self.cfg = cfg
        self.device = resolve_device(device)
        _register(self, param_spec(cfg), _dtype(cfg), self.device)
        self.blocks = nn.ModuleList(Block(cfg, kind, self.device)
                                    for kind in layer_kinds(cfg))
        self.tp = None

    def set_tensor_parallel(self, tp) -> None:
        """Run as one rank's share of a 'model' group
        (``models/tensor_parallel.TensorParallel``): the blocks take the
        share's configuration, the embedding and head their vocabulary
        blocks.  The caller gives the parameters their shares.  The
        dense, vlm and moe families only (``TensorParallel.fits``)."""
        if not tp.fits(self.cfg, tp.size):
            raise ValueError(f"{self.cfg.name}: tensor parallelism over "
                             f"{tp.size} ranks splits the attention and "
                             "SwiGLU or expert FFN of the dense, vlm and "
                             "moe families into whole blocks")
        self.tp = tp
        for blk in self.blocks:
            blk.tp, blk.cfg = tp, tp.local_config(self.cfg)

    def embed_inputs(self, tokens=None, *, frames=None, vision=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(x (B, S, D), positions (B, S)) from the family's inputs:
        ``frames`` (B, S, frontend_dim) for audio; ``tokens`` (B, S_t)
        otherwise, after ``vision`` (B, n_vis, D), the stub patch
        embeddings, for vlm."""
        cfg, cdt = self.cfg, _cdtype(self.cfg)
        audio, vlm = cfg.family == "audio", cfg.family == "vlm"
        if (frames is not None) != audio or (tokens is not None) == audio \
                or (vision is not None) != vlm:
            raise ValueError(
                f"{cfg.name} ({cfg.family}) takes "
                + ("frames=" if audio else "tokens and vision=" if vlm
                   else "tokens") + f"; got tokens={tokens is not None}, "
                f"frames={frames is not None}, vision={vision is not None}")
        if audio:
            frames = torch.as_tensor(frames, device=self.device)
            x = frames.to(cdt) @ self.frontend_proj.to(cdt)
        else:
            x = self.lookup(tokens)
            if vlm:
                vision = torch.as_tensor(vision, device=self.device)
                x = torch.cat([vision.to(cdt), x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device)[None].expand(b, s)
        return x, positions

    def lookup(self, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens`` in the compute dtype.  Under
        tensor parallelism the table is this rank's block: of the
        vocabulary (the training layout; ``TensorParallel.embed``), or of
        ``d_model`` (the decode layout, ``param_pspecs(decode=True)``: the
        columns looked up here and gathered)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        table = self.embed.to(_cdtype(self.cfg))
        if self.tp is not None and table.shape[0] != self.cfg.padded_vocab:
            return self.tp.embed(tokens, table)
        # the lookup as F.embedding: the same rows, and a backward that
        # sums each row's gradient in a fixed order (indexing's
        # accumulating backward does not)
        x = F.embedding(tokens, table)
        if self.tp is not None and table.shape[1] != self.cfg.d_model:
            x = self.tp.gather_last(x)
        return x

    def forward(self, tokens: torch.Tensor | None = None,
                ffn_inputs: list | None = None, *, frames=None,
                vision=None, gather: bool = True) -> torch.Tensor:
        """Logits (B, S, padded_vocab) in float32 (for vlm, S counts the
        vision tokens first).  ``ffn_inputs``, when given, collects each
        block's FFN input (B, S, D) in order (ssm blocks have none), and
        turns remat off: a recomputed block would collect twice.  Under
        tensor parallelism ``gather=False`` leaves the logits split by
        vocabulary, this rank's columns (:meth:`lm_logits`)."""
        x, positions = self.embed_inputs(tokens, frames=frames,
                                         vision=vision)
        remat = _REMAT.get(self.cfg.remat) if (
            torch.is_grad_enabled() and ffn_inputs is None) else None
        # seq_parallel: the residual stream between blocks is
        # sequence-sharded over 'model' under a mesh
        seq_ax = "model" if self.cfg.seq_parallel else None
        x = constrain(x, "dp", seq_ax, None)
        for blk in self.blocks:
            if remat is None:
                x = blk(x, positions, ffn_inputs)
            else:
                x = remat(blk, x, positions)
            x = constrain(x, "dp", seq_ax, None)
        x = rms_norm(x, self.final_norm)
        return self.lm_logits(x, gather)

    def lm_logits(self, x: torch.Tensor, gather: bool = True
                  ) -> torch.Tensor:
        """(..., D) -> (..., padded_vocab) float32 logits, the pad columns
        past ``vocab_size`` at -1e30; under tensor parallelism with a head
        split by vocabulary and ``gather=False``, this rank's block of
        the columns."""
        if self.cfg.family == "audio":
            head = self.head
        elif self.cfg.tie_embeddings:
            head = self.embed.T
        else:
            head = self.lm_head
        if self.tp is None or head.shape == (self.cfg.d_model,
                                             self.cfg.padded_vocab):
            logits = (x @ head.to(x.dtype)).float()
        elif head.shape[0] != self.cfg.d_model:
            # the tied head of a d_model-split table: a partial product of
            # this rank's columns of x, summed over the group
            n = head.shape[0]
            xr = x[..., self.tp.rank * n:(self.tp.rank + 1) * n]
            logits = self.tp.exit(xr @ head.to(x.dtype)).float()
        else:
            logits = (self.tp.enter(x) @ head.to(x.dtype)).float()
            n = logits.shape[-1]
            pad = self.cfg.vocab_size - self.tp.rank * n
            if pad < n:
                logits[..., max(pad, 0):] = -1e30
            return self.tp.gather_last(logits) if gather else logits
        if self.cfg.padded_vocab != self.cfg.vocab_size:
            logits[..., self.cfg.vocab_size:] = -1e30
        spec = ["dp"] + [None] * (logits.ndim - 2) + ["model"]
        return constrain(logits, *spec)


# the reference's jax.checkpoint policies: "dots" saves the outputs of the
# matrix products (checkpoint_dots) and recomputes everything else
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]
_REMAT = {
    "full": partial(checkpoint, use_reentrant=False),
    "dots": partial(checkpoint, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, _DOTS)),
}


def train_loss(model: Transformer, batch: dict) -> torch.Tensor:
    """The reference's loss of ``batch``: for audio the cross-entropy of
    ``frames``' logits against ``labels`` (B, S); for vlm the next-token
    loss of the text after the ``vision`` embeddings; otherwise the mean
    next-token cross-entropy of ``tokens`` (B, S), the logits at 0..S-2
    against the tokens at 1..S-1.  Under tensor parallelism it runs on
    the logits split by vocabulary (``TensorParallel.vocab_xent``)."""
    cfg = model.cfg
    logits = model(batch.get("tokens"), frames=batch.get("frames"),
                   vision=batch.get("vision"), gather=False)
    # under tensor parallelism the logits stay split by vocabulary
    xent = softmax_xent if logits.shape[-1] == cfg.padded_vocab else \
        model.tp.vocab_xent
    if cfg.family == "audio":
        labels = torch.as_tensor(batch["labels"], device=model.device)
        return xent(logits, labels)
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    if cfg.family == "vlm":
        logits = logits[:, batch["vision"].shape[1]:]
    return xent(logits[:, :-1], tokens[:, 1:])


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """A :class:`Transformer` with every parameter drawn from
    ``generator`` (on the model's device): normal(0.02) weights, unit
    norms, zero biases, the RG-LRU's ``lam`` at 4.0 (the reference's
    Griffin init), in ``cfg.param_dtype``."""
    model = Transformer(cfg, device)
    for mod in (model, *model.blocks):
        for name, param in mod.named_parameters(recurse=False):
            if name == "lam":
                param.fill_(4.0)
            else:
                _INITS[mod.init_kinds[name]](param, generator)
    return model
