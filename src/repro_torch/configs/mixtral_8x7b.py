# Copied from src/repro/configs/mixtral_8x7b.py; only the repro imports differ.
"""mixtral-8x7b [moe] — 32L d4096 32H (GQA kv=8) ff14336 V32000,
8 experts top-2, SWA window 4096 [arXiv:2401.04088; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab_size=32000, head_dim=128,
    n_experts=8, experts_per_token=2, sliding_window=4096,
    rope_theta=1e6, remat="full", seq_parallel=True)

SMOKE = CONFIG.with_(
    name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, n_experts=4,
    experts_per_token=2, sliding_window=16, remat="none",
    capacity_factor=4.0,   # dropless at smoke scale: deterministic tests
    param_dtype="float32", compute_dtype="float32")
