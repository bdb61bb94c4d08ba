"""Architecture registry of the port: the configurations it serves."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
    list_archs,
)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "get_config", "get_smoke_config", "list_archs"]
