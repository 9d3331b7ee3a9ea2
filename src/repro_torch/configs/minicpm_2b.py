# Copied from src/repro/configs/minicpm_2b.py; only the repro imports differ.
"""minicpm-2b [dense] — 40L d2304 36H (MHA kv=36) ff5760 V122753, WSD
schedule, tied embeddings (llama-like arch) [arXiv:2404.06395; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304, n_heads=36,
    n_kv_heads=36, d_ff=5760, vocab_size=122753, head_dim=64,
    tie_embeddings=True, rope_theta=1e4, remat="full", seq_parallel=True)

# training recipe marker consumed by launch/train.py (MiniCPM's WSD)
LR_SCHEDULE = "wsd"

SMOKE = CONFIG.with_(
    name="minicpm-2b-smoke", n_layers=2, d_model=72, n_heads=6, n_kv_heads=6,
    d_ff=144, vocab_size=512, head_dim=12, remat="none",
    param_dtype="float32", compute_dtype="float32")
