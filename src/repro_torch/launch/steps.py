"""Step functions: the prefill and serve steps the serving loop calls.

The reference builds pure functions for ``jax.jit`` with explicit shardings;
PyTorch runs eagerly on one device, so a step here is the model function
with its config and cache size bound, run under ``torch.inference_mode``.
Training steps come with the training slice (ROADMAP.md queue 1, item 8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import ModelConfig, decode_step, prefill

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig, S_max: Optional[int] = None):
    """(params, batch) -> (last logits (B, vocab) f32, cache)."""
    @torch.inference_mode()
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, S_max=S_max)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, cache, batch, pos) -> (logits (B, vocab) f32, new cache)."""
    @torch.inference_mode()
    def serve_step(params, cache, batch, pos: int):
        return decode_step(params, cfg, cache, batch, pos)

    return serve_step
