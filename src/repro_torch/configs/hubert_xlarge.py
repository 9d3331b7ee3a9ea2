# Copied from src/repro/configs/hubert_xlarge.py; only the repro imports differ.
"""hubert-xlarge [audio] — 48L d1280 16H (MHA kv=16) ff5120 V504 (cluster
codes), encoder-only; conv frontend is a STUB: input_specs provides
precomputed frame features (dim 512) [arXiv:2106.07447; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504, head_dim=80,
    is_encoder=True, frontend_dim=512, remat="full", seq_parallel=True)

SMOKE = CONFIG.with_(
    name="hubert-xlarge-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=64, head_dim=16, frontend_dim=16,
    remat="none", param_dtype="float32", compute_dtype="float32")
