"""Step functions: the train step the trainer calls, and the prefill and
serve steps the serving loop calls.

The reference builds pure functions for ``jax.jit`` with explicit shardings;
PyTorch runs eagerly on one device, so a step here is the model function
with its config bound.  The serving steps run under
``torch.inference_mode``; the train step under autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import ModelConfig, decode_step, prefill, train_loss
from repro_torch.optim import OptConfig, adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the loss
    and its gradients, then one AdamW step.  ``params`` (an ``LM``) takes
    gradients for the step and is updated in place with the new values (its
    float32 masters rounded once to each parameter's dtype); ``opt_state`` is
    updated in place too (``adamw_update``).  metrics: {"loss", "grad_norm",
    "lr"}, float32 scalars on the device (no synchronize)."""
    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        loss = train_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        new, opt_state, metrics = adamw_update(opt_cfg, dict(zip(named, grads)), opt_state)
        del grads
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(new.pop(name))
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


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
