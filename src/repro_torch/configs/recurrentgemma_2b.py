# Copied from src/repro/configs/recurrentgemma_2b.py; only the repro imports differ.
"""recurrentgemma-2b [hybrid] — 26L d2560 10H (MQA kv=1, hd=256) ff7680
V256000, RG-LRU + local attn pattern (rec, rec, attn), window 2048
[arXiv:2402.19427; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), local_window=2048,
    tie_embeddings=True, rope_theta=1e4, scan_layers=True, remat="full",
    seq_parallel=True)   # scan_layers: scans (rec, rec, attn) GROUPS

SMOKE = CONFIG.with_(
    name="recurrentgemma-2b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab_size=512, head_dim=16, local_window=16,
    remat="none", param_dtype="float32", compute_dtype="float32")
