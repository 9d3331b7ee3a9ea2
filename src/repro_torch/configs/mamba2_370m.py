# Copied from src/repro/configs/mamba2_370m.py; only the repro imports differ.
"""mamba2-370m [ssm] — 48L d1024 attn-free, ssm_state=128, V50280,
SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_chunk=64, ssm_expand=2,
    tie_embeddings=True, remat="full",
    # 370M params replicate comfortably: pure DP (batch over 'model' too).
    # Measured §Perf: collective term 3.65s -> 94ms (39x) vs TP sharding.
    tensor_parallel=False, seq_parallel=False)

SMOKE = CONFIG.with_(
    name="mamba2-370m-smoke", n_layers=2, d_model=64, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8, remat="none",
    param_dtype="float32", compute_dtype="float32")
