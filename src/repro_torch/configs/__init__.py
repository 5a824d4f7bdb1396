from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_cells,
    cells,
    get_config,
    get_tiny_config,
)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "all_cells", "cells",
           "get_config", "get_tiny_config"]
