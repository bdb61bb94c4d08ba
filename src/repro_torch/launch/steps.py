"""Step functions: the train step the trainer calls, and the prefill and
serve steps the serving loop calls.

The reference builds pure functions for ``jax.jit`` with explicit shardings,
entering the sharding-rules context inside so the model's ``shard()``
annotations resolve against the mesh.  PyTorch runs eagerly: a step here is
the model function with its config bound, run under ``axis_rules(rules)``.
Without rules it runs on one device.  With rules every rank calls it (one
process a rank, ``launch/mesh.py``): the parameters are DTensors placed by
their logical axes (``param_sharding.shard_params``), a batch given whole
on every rank is placed by ``batch_logical_axes``, and plain tensors the
model makes beside DTensors count as replicated.  The serving steps run
under ``torch.inference_mode`` (``no_grad`` on a mesh); the train step under
autograd.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.param_sharding import batch_logical_axes
from repro_torch.distributed.sharding import (
    AxisRules,
    axis_rules,
    placements,
    resolve_spec,
)
from repro_torch.models import ModelConfig, decode_step, prefill, train_loss
from repro_torch.optim import OptConfig, adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step", "place_batch"]


def place_batch(cfg: ModelConfig, batch: dict, rules: Optional[AxisRules], kind: str) -> dict:
    """A batch held whole on every rank, placed on the rules' mesh by
    ``batch_logical_axes`` (each rank keeps its shard); as it is without
    rules, and a DTensor entry as it is."""
    if rules is None:
        return batch
    axes = batch_logical_axes(cfg, kind)
    out = {}
    for k, t in batch.items():
        if k in axes and isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
            where = placements(rules.mesh, resolve_spec(rules, t.shape, axes[k]))
            t = distribute_tensor(t, rules.mesh, where, src_data_rank=None)
        out[k] = t
    return out


@contextlib.contextmanager
def _on(rules: Optional[AxisRules]):
    """The rules' context; with rules, plain tensors beside DTensors count
    as replicated."""
    with axis_rules(rules), (implicit_replication() if rules is not None
                             else contextlib.nullcontext()):
        yield


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    rules: Optional[AxisRules] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the loss
    and its gradients, then one AdamW step.  ``params`` (an ``LM``) takes
    gradients for the step and is updated in place with the new values (its
    float32 masters rounded once to each parameter's dtype); ``opt_state`` is
    updated in place too (``adamw_update``).  Each gradient is laid out as
    its parameter is (a sharded parameter's partial sums reduced).
    metrics: {"loss", "grad_norm", "lr"}, float32 scalars on the device (no
    synchronize)."""
    def train_step(params, opt_state, batch):
        with _on(rules):
            batch = place_batch(cfg, batch, rules, "train")
            params.requires_grad_(True)
            named = dict(params.named_parameters())
            loss = train_loss(params, cfg, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if isinstance(g, DTensor) else g for g, p in zip(grads, named.values())]
            new, opt_state, metrics = adamw_update(opt_cfg, dict(zip(named, grads)), opt_state)
            del grads
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(new.pop(name))
            metrics = {k: _whole(v) for k, v in metrics.items()}
            metrics["loss"] = _whole(loss.detach())
        return params, opt_state, metrics

    return train_step


def _serving(rules: Optional[AxisRules]):
    """``inference_mode`` on one device; ``no_grad`` on a mesh (DTensor's
    views of a parameter fail under ``inference_mode``)."""
    return torch.inference_mode() if rules is None else torch.no_grad()


def make_prefill_step(cfg: ModelConfig, rules: Optional[AxisRules] = None,
                      S_max: Optional[int] = None):
    """(params, batch) -> (last logits (B, vocab) f32, cache)."""
    def prefill_step(params, batch):
        with _serving(rules), _on(rules):
            return prefill(params, cfg, place_batch(cfg, batch, rules, "prefill"),
                           S_max=S_max)

    return prefill_step


def make_serve_step(cfg: ModelConfig, rules: Optional[AxisRules] = None):
    """(params, cache, batch, pos) -> (logits (B, vocab) f32, new cache)."""
    def serve_step(params, cache, batch, pos: int):
        with _serving(rules), _on(rules):
            return decode_step(params, cfg, cache, place_batch(cfg, batch, rules, "decode"),
                               pos)

    return serve_step
