"""The dense transformer: parameters, forward, logits and the training
loss.

Port of ``src/repro/models/transformer.py`` for ``family="dense"``
(llama/qwen-style GQA + SwiGLU, qk-norm, tied embeddings for minicpm) as a
:class:`Transformer` ``nn.Module`` with an ``nn.ModuleList`` of
:class:`Block`s.  Each block's parameters carry the reference's names
(``attn_norm``, ``wq``, ``wk``, ``wv``, ``wo``, ``q_norm``, ``k_norm``,
``mlp_norm``, ``w_gate``, ``w_up``, ``w_down``), so ``block.params()`` is
the per-layer dict the layer functions take, and the state dict is the
reference's tree with the stacked ``blocks`` split per layer
(``convert.transformer_params_from_reference``).

With ``cfg.logic_mlp`` a block's FFN is the binarized MLP of
``models/logic_mlp.py`` (``w_in``, ``b_in``, ``w_out``): it runs
``binary_ffn`` until the block is given a compiled program
(``block.program``), and ``logic_ffn_apply`` (K1 on the card) after.

The forward records autograd only where grad is enabled and the
parameters ask for it: the model is built with ``requires_grad`` off, the
trainer turns it on, and the serving paths run under
``torch.inference_mode()``.  ``cfg.remat`` (the reference's
``_maybe_remat``) applies while grad is enabled: ``"full"`` checkpoints
each block (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` saves
only the matrix products' outputs and recomputes the rest, ``"none"`` is
the plain loop.  :func:`train_loss` is the reference's next-token loss of
the dense family.

Dropped, because one device has no use for them: ``constrain`` (sharding
annotations) and ``seq_parallel`` (sequence-sharded activations); they
come with the sharded trainer (ROADMAP queue 1 item 3).  The layer scan
is a Python loop over the blocks.  Any other family raises
``NotImplementedError``: the MoE, SSM, hybrid, audio and VLM families are
ROADMAP queue 1 item 5.
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
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (DTYPES, normal_init, ones_init,
                                       rms_norm, softmax_xent, swiglu,
                                       zeros_init)
from repro_torch.models.logic_mlp import binary_ffn, logic_ffn_apply


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP "
            "queue 1 item 5); the port serves the dense family")


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
    return {"mlp_norm": ("ones", (d,)),
            "w_gate": ("normal", (d, cfg.d_ff)),
            "w_up": ("normal", (d, cfg.d_ff)),
            "w_down": ("normal", (cfg.d_ff, d))}


def block_param_spec(cfg: ModelConfig) -> dict:
    """One dense block's ``{name: (init_kind, shape)}``."""
    d = cfg.d_model
    return {**_attn_params(cfg, d), **_mlp_params(cfg, d)}


def param_spec(cfg: ModelConfig) -> dict:
    """The model's top-level ``{name: (init_kind, shape)}`` (blocks
    aside)."""
    d = cfg.d_model
    spec = {"final_norm": ("ones", (d,)),
            "embed": ("normal", (cfg.padded_vocab, d))}
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


class Block(nn.Module):
    """One dense block: pre-norm attention, then a pre-norm FFN (SwiGLU,
    or the binarized / logic FFN with ``cfg.logic_mlp``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        _register(self, block_param_spec(cfg), _dtype(cfg), device)
        self.program = None         # the logic FFN's compiled program

    def params(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def ffn(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        if not self.cfg.logic_mlp:
            return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        if self.program is None:
            return binary_ffn(p, h)
        return logic_ffn_apply(self.program, p, h)

    def forward(self, x, positions, window: int = 0,
                ffn_inputs: list | None = None) -> torch.Tensor:
        p = self.params()
        h = rms_norm(x, p["attn_norm"])
        x = x + attn.attention_forward(p, h, self.cfg, positions=positions,
                                       causal=True, window=window)
        h = rms_norm(x, p["mlp_norm"])
        if ffn_inputs is not None:
            ffn_inputs.append(h)
        return x + self.ffn(p, h)


class Transformer(nn.Module):
    """The dense decoder: ``embed``, ``blocks``, ``final_norm`` and (unless
    the embeddings are tied) ``lm_head``, in ``cfg.param_dtype`` on
    ``device`` (CUDA unless ``"cpu"``).  The parameters are allocated, not
    initialized: :func:`init_params` fills them from a generator, and
    ``load_state_dict`` from carried-across weights."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        _register(self, param_spec(cfg), _dtype(cfg), self.device)
        self.blocks = nn.ModuleList(Block(cfg, self.device)
                                    for _ in range(cfg.n_layers))

    @property
    def window(self) -> int:
        return self.cfg.sliding_window

    def embed_inputs(self, tokens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (x (B, S, D), positions (B, S))."""
        tokens = torch.as_tensor(tokens, device=self.device)
        # the lookup as F.embedding: the same rows, and a backward that
        # sums each row's gradient in a fixed order (indexing's
        # accumulating backward does not)
        x = F.embedding(tokens, self.embed.to(_cdtype(self.cfg)))
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device)[None].expand(b, s)
        return x, positions

    def forward(self, tokens: torch.Tensor,
                ffn_inputs: list | None = None) -> torch.Tensor:
        """Logits (B, S, padded_vocab) in float32.  ``ffn_inputs``, when
        given, collects each block's FFN input (B, S, D) in order (and
        turns remat off: a recomputed block would collect twice)."""
        x, positions = self.embed_inputs(tokens)
        remat = _REMAT.get(self.cfg.remat) if (
            torch.is_grad_enabled() and ffn_inputs is None) else None
        for blk in self.blocks:
            if remat is None:
                x = blk(x, positions, self.window, ffn_inputs)
            else:
                x = remat(blk, x, positions, self.window)
        x = rms_norm(x, self.final_norm)
        return self.lm_logits(x)

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., padded_vocab) float32 logits, the pad columns
        past ``vocab_size`` at -1e30."""
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = (x @ head.to(x.dtype)).float()
        if self.cfg.padded_vocab != self.cfg.vocab_size:
            logits[..., self.cfg.vocab_size:] = -1e30
        return logits


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
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S): the
    logits at positions 0..S-2 against the tokens at 1..S-1."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    logits = model(tokens)
    return softmax_xent(logits[:, :-1], tokens[:, 1:])


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """A :class:`Transformer` with every parameter drawn from
    ``generator`` (on the model's device): normal(0.02) weights, unit
    norms, zero biases, in ``cfg.param_dtype``."""
    model = Transformer(cfg, device)
    for mod in (model, *model.blocks):
        for name, param in mod.named_parameters(recurse=False):
            _INITS[mod.init_kinds[name]](param, generator)
    return model
