"""LM substrate of the port: pattern-based stacks, trained and served."""
from repro_torch.models.lm import (
    LM,
    Block,
    ModelConfig,
    cache_from_jax,
    cache_shapes,
    cache_to_numpy,
    decode_step,
    forward_hidden,
    grads_to_numpy,
    init_cache,
    init_params,
    param_shapes,
    params_from_jax,
    prefill,
    train_loss,
)
from repro_torch.models.moe import MoEConfig

__all__ = [
    "LM", "Block", "ModelConfig", "MoEConfig", "cache_from_jax", "cache_shapes",
    "cache_to_numpy", "decode_step", "forward_hidden", "grads_to_numpy", "init_cache",
    "init_params", "param_shapes", "params_from_jax", "prefill", "train_loss",
]
