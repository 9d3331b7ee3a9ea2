# Copied from src/repro/configs/grok1_314b.py; only the repro imports differ.
"""grok-1-314b [moe] — 64L d6144 48H (GQA kv=8) ff32768 V131072,
8 experts top-2, full attention [hf:xai-org/grok-1; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab_size=131072, head_dim=128,
    n_experts=8, experts_per_token=2, rope_theta=1e4, remat="full", seq_parallel=True,
    moment_dtype="bfloat16")   # 314B: fp32 moments would not fit v5e HBM

SMOKE = CONFIG.with_(
    name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=512, head_dim=16, n_experts=4,
    experts_per_token=2, remat="none",
    capacity_factor=4.0,   # dropless at smoke scale: deterministic tests
    param_dtype="float32", compute_dtype="float32", moment_dtype="float32")
