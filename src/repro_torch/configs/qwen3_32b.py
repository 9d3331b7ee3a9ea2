# Copied from src/repro/configs/qwen3_32b.py; only the repro imports differ.
"""qwen3-32b [dense] — 64L d5120 64H (GQA kv=8) ff25600 V151936, qk_norm
[hf:Qwen/Qwen3-32B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, remat="full", seq_parallel=True)

SMOKE = CONFIG.with_(
    name="qwen3-32b-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=320, vocab_size=512, head_dim=16, remat="none",
    param_dtype="float32", compute_dtype="float32")
