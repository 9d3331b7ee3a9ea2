from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     resolve_moment_dtype)
from repro_torch.optim.schedule import (wsd_schedule, cosine_schedule,
                                        linear_warmup)
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           ErrorFeedbackState, ef_init,
                                           ef_compress, ef_decompress_apply)

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "resolve_moment_dtype",
    "wsd_schedule", "cosine_schedule", "linear_warmup",
    "clip_by_global_norm",
    "compress_int8", "decompress_int8", "ErrorFeedbackState", "ef_init",
    "ef_compress", "ef_decompress_apply",
]
