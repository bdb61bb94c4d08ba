"""AdamW with float32 master weights, a cosine schedule and global-norm
clipping, as the reference package's ``optim/adamw.py`` computes it.

The model's parameters live in their compute dtype (bf16 for the configs);
the optimizer holds a float32 master copy and float32 moments, one tensor
per parameter, keyed by the parameter's name.  The update runs in float32,
in the reference's order of operations, and each new parameter is its
master rounded once to the parameter's dtype.  ``torch.optim.AdamW`` is not
used: it has no global-norm clip and no float32 master, and it groups the
decay and the step differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Tuple, Union

import torch
from torch import nn

__all__ = ["OptConfig", "adamw_init", "adamw_init_shapes", "adamw_update", "cosine_lr",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to ``min_lr_ratio``
    of it at ``total_steps``; float32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their float32 sums of squares.  A
    sharded (DTensor) tensor's sum is reduced across its shards."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: Params) -> dict:
    """{"step": int32 0, "master": float32 copies, "mu": zeros, "nu": zeros},
    each a dict keyed by parameter name (an ``nn.Module``'s
    ``named_parameters`` or a mapping's keys), on the parameters' devices
    (sharded as they are: a DTensor parameter's state is a DTensor with its
    placements)."""
    named = _named(params)
    first = next(iter(named.values()))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "master": {k: p.detach().float().clone() for k, p in named.items()},
        "mu": {k: torch.zeros_like(p, dtype=torch.float32).detach() for k, p in named.items()},
        "nu": {k: torch.zeros_like(p, dtype=torch.float32).detach() for k, p in named.items()},
    }


def adamw_init_shapes(param_shapes) -> dict:
    """:func:`adamw_init`'s state as meta-device tensors (no memory), for a
    parameter tree of any nesting (``models.param_shapes``'s): "step" int32,
    "master", "mu" and "nu" float32 trees of the parameters' structure."""
    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(f32(v) for v in tree)
        return torch.empty(tuple(tree.shape), dtype=torch.float32, device="meta")

    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "master": f32(param_shapes), "mu": f32(param_shapes), "nu": f32(param_shapes)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Mapping[str, torch.Tensor], opt_state: dict):
    """One AdamW step: returns (new params {name: tensor in its gradient's
    dtype}, the new optimizer state, {"lr", "grad_norm"}).

    The state's tensors are updated IN PLACE (and the same dict returned):
    the float32 state of a 3 B-parameter model is 39 GB, which a copy beside
    it would double.  Each value is computed as the reference computes it
    (clip, then the moments, the bias corrections and the decayed step,
    one float32 operation at a time), one parameter at a time."""
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.betas
    gnorm = global_norm(grads.values())
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    new_params = {}
    for name, g in grads.items():
        gc = g.float() * clip
        m = opt_state["mu"][name].mul_(b1).add_((1 - b1) * gc)
        v = opt_state["nu"][name].mul_(b2).add_((1 - b2) * torch.square(gc))
        w = opt_state["master"][name]
        w.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * w))
        new_params[name] = w.to(g.dtype)
    opt_state["step"] = step
    return new_params, opt_state, {"lr": lr, "grad_norm": gnorm}
