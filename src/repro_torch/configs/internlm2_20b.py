# Copied from src/repro/configs/internlm2_20b.py; only the repro imports differ.
"""internlm2-20b [dense] — 48L d6144 48H (GQA kv=8) ff16384 V92544
[arXiv:2403.17297; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=92544, head_dim=128,
    rope_theta=1e6, remat="full", seq_parallel=True)

SMOKE = CONFIG.with_(
    name="internlm2-20b-smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, d_ff=192, vocab_size=512, head_dim=16, remat="none",
    param_dtype="float32", compute_dtype="float32")
