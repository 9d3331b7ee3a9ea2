# Port of src/repro/configs/__init__.py: the same exports but input_specs.
from repro_torch.configs.registry import (ARCH_IDS, get_config, SHAPES,
                                          cell_supported, all_cells)

__all__ = ["ARCH_IDS", "get_config", "SHAPES", "cell_supported",
           "all_cells"]
