# ARCH_IDS, get_config, ShapeCell, SHAPES, cell_supported and all_cells
# copied from src/repro/configs/registry.py; _MODULES names this package's
# config modules.  input_specs (the dry run's jax.ShapeDtypeStruct
# stand-ins) waits for the port of launch/dryrun.
"""Architecture registry + assigned shape cells.

Shapes (assignment spec):
  train_4k     seq 4,096  x global_batch 256  (training; lowers train_step)
  prefill_32k  seq 32,768 x global_batch 32   (inference prefill)
  decode_32k   seq 32,768 x global_batch 128  (one token, KV ctx = 32k)
  long_500k    seq 524,288 x global_batch 1   (one token, sub-quadratic only)

``cell_supported`` encodes the mandated skips (DESIGN.md §6): decode shapes
are N/A for encoder-only; long_500k is N/A for pure full-attention archs.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen3-8b", "internlm2-20b", "minicpm-2b", "qwen3-32b", "mixtral-8x7b",
    "grok-1-314b", "mamba2-370m", "hubert-xlarge", "internvl2-76b",
    "recurrentgemma-2b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_") for a in ARCH_IDS}
_MODULES["grok-1-314b"] = "repro_torch.configs.grok1_314b"


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    cell = SHAPES[shape]
    if cfg.is_encoder and cell.kind == "decode":
        return False, "encoder-only: no decode step"
    if shape == "long_500k":
        subq = (cfg.family in ("ssm", "hybrid")) or cfg.sliding_window > 0
        if not subq:
            return False, "pure full attention: 500k decode needs " \
                          "sub-quadratic attention (DESIGN.md §6)"
    return True, ""


def all_cells(smoke: bool = False):
    """Yield (arch, shape, supported, reason) for the full 40-cell table."""
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=smoke)
        for shape in SHAPES:
            ok, reason = cell_supported(cfg, shape)
            yield arch, shape, ok, reason
