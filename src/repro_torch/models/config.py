# Copied from src/repro/models/config.py (a pure dataclass).
"""Unified model configuration covering all assigned architecture families."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    sliding_window: int = 0        # 0 = full attention (SWA if > 0)
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # hybrid (recurrentgemma / Griffin)
    block_pattern: tuple = ()      # e.g. ("rec", "rec", "attn") repeated
    local_window: int = 0          # local-attn window for hybrid blocks
    rglru_c: float = 8.0
    # encoder-only / modality frontends (STUBS per assignment spec)
    is_encoder: bool = False
    frontend_dim: int = 0          # audio: precomputed frame-feature dim
    vision_tokens: int = 0         # vlm: precomputed patch embeddings count
    # numerics / memory
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat: str = "full"            # none | full | dots
    scan_layers: bool = True
    # parallelism knobs (read by sharding.py / launch)
    seq_parallel: bool = False     # shard activation seq dim over 'model'
    tensor_parallel: bool = True   # False: pure-DP (batch over 'model' too;
                                   # params replicated on 'model') — right
                                   # call for sub-1B models where TP
                                   # collectives swamp compute (§Perf)
    # paper technique integration
    logic_mlp: bool = False        # FFCL-substituted FFN (inference only)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (Megatron-style): lane-aligned
        AND divisible by the 16-wide 'model' axis — an un-shardable vocab
        (e.g. minicpm's 122753) replicates the fp32 logits on every device
        (+30 GiB/dev at train_4k, §Perf). Pad columns are masked to -inf."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = self.ssm_heads or (d_in // self.ssm_head_dim)
            per = (d * (2 * d_in + 2 * self.ssm_state + nh)   # in_proj
                   + self.ssm_conv_width * (d_in + 2 * self.ssm_state)
                   + nh + nh                                  # A_log, D
                   + d_in                                      # norm
                   + d_in * d)                                 # out_proj
            blocks = self.n_layers * (per + d)
            return blocks + self.vocab_size * d * (1 if self.tie_embeddings
                                                   else 2) + d
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family == "moe":
            e = (self.experts_per_token if active_only else self.n_experts)
            mlp = e * 3 * d * self.d_ff + d * self.n_experts  # + router
        elif self.family == "hybrid":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 3 * d * self.d_ff
        if self.family == "audio":                            # enc: GeLU MLP
            mlp = 2 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        if self.family == "hybrid":
            # recurrent blocks replace attention with RG-LRU machinery
            n_attn = sum(1 for i in range(self.n_layers)
                         if self.block_pattern[i % len(self.block_pattern)]
                         == "attn")
            n_rec = self.n_layers - n_attn
            d_rnn = self.n_heads * hd
            rec = (2 * d * d_rnn + d_rnn * d            # in/out proj (gated)
                   + self.ssm_conv_width * d_rnn        # temporal conv
                   + 2 * d_rnn + 2 * d_rnn)             # gates a/x
            per_attn = attn + mlp + 2 * d
            per_rec = rec + mlp + 2 * d
            blocks = n_attn * per_attn + n_rec * per_rec
        else:
            blocks = self.n_layers * per_layer
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "audio":
            emb = self.frontend_dim * d + d * self.vocab_size
        return blocks + emb + d
