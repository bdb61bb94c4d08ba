"""Optimizer substrate: AdamW with float32 master weights."""
from repro_torch.optim.adamw import (
    OptConfig,
    adamw_init,
    adamw_init_shapes,
    adamw_update,
    cosine_lr,
    global_norm,
)

__all__ = ["OptConfig", "adamw_init", "adamw_init_shapes", "adamw_update", "cosine_lr",
           "global_norm"]
