# Copied from src/repro/configs/qwen3_8b.py; only the repro imports differ.
"""qwen3-8b [dense] — 36L d4096 32H (GQA kv=8) ff12288 V151936, qk_norm
[hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=12288, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, remat="full", seq_parallel=True)

SMOKE = CONFIG.with_(
    name="qwen3-8b-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32, remat="none",
    param_dtype="float32", compute_dtype="float32")
