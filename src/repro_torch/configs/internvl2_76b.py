# Copied from src/repro/configs/internvl2_76b.py; only the repro imports differ.
"""internvl2-76b [vlm] — 80L d8192 64H (GQA kv=8) ff28672 V128256 LM
backbone (InternViT frontend is a STUB: input_specs provides precomputed
patch embeddings) [arXiv:2404.16821; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab_size=128256, head_dim=128,
    vision_tokens=256, rope_theta=5e5, remat="full", seq_parallel=True,
    moment_dtype="bfloat16")

SMOKE = CONFIG.with_(
    name="internvl2-76b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=16, vision_tokens=8,
    remat="none", param_dtype="float32", compute_dtype="float32",
    moment_dtype="float32")
