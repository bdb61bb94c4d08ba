"""Architecture registry of the port: the configurations it serves."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    cells,
    get_config,
    get_smoke_config,
    list_archs,
    shape_applicable,
)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "cells", "get_config", "get_smoke_config",
           "list_archs", "shape_applicable"]
