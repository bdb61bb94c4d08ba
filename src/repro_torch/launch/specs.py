"""Abstract inputs for every (arch x shape) cell, the reference's
``launch/specs.py``.

Nothing is allocated here: parameters, optimizer state, caches and batches
are meta-device tensors (shape and dtype only).  With sharding rules each
stand-in is paired with the placements its logical axes resolve to on the
rules' mesh (:class:`Placed`), as the reference attaches a
``NamedSharding`` to each ``ShapeDtypeStruct``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.param_sharding import (
    _is_axes,
    batch_logical_axes,
    cache_logical_axes,
    param_logical_axes,
)
from repro_torch.distributed.sharding import AxisRules, P, placements, resolve_spec
from repro_torch.models import ModelConfig, cache_shapes, param_shapes
from repro_torch.optim import adamw_init_shapes

__all__ = ["Placed", "input_specs", "attach_shardings", "abstract_state", "abstract_batch",
           "abstract_cache"]


class Placed(NamedTuple):
    """A meta-device stand-in with its resolved spec and DTensor placements
    on the rules' mesh."""
    value: torch.Tensor
    spec: P
    placements: tuple


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Abstract batch for one shape spec."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        if cfg.input_mode == "tokens":
            return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        out = {"embeds": _meta((B, S, cfg.d_model), bf16), "labels": _meta((B, S), i32)}
        if cfg.pos == "mrope":
            out["pos_ids"] = _meta((3, B, S), i32)
        return out
    if shape.kind in ("prefill", "decode"):
        S = S if shape.kind == "prefill" else 1
        if cfg.input_mode == "tokens":
            return {"tokens": _meta((B, S), i32)}
        out = {"embeds": _meta((B, S, cfg.d_model), bf16)}
        if cfg.pos == "mrope":
            out["pos_ids"] = _meta((3, B, S), i32)
        return out
    raise ValueError(shape.kind)


def attach_shardings(rules: AxisRules, tree: Any, logical: Any) -> Any:
    """The tree with each stand-in paired with its placements
    (divisibility-checked, as ``tree_shardings`` resolves them)."""
    if _is_axes(logical):
        spec = resolve_spec(rules, tuple(tree.shape), logical)
        return Placed(tree, spec, placements(rules.mesh, spec))
    if isinstance(tree, dict):
        return {k: attach_shardings(rules, tree[k], logical[k]) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(attach_shardings(rules, t, l) for t, l in zip(tree, logical))
    raise TypeError(f"no logical axes for {type(tree).__name__}")


def abstract_state(cfg: ModelConfig, rules: Optional[AxisRules], with_opt: bool = True):
    """(params, opt state) as meta tensors in the reference's stacked tree
    (``models.param_shapes``), placed when rules are given."""
    ps = param_shapes(cfg)
    logical = param_logical_axes(ps)
    if rules is not None:
        ps = attach_shardings(rules, ps, logical)
    opt = None
    if with_opt:
        opt = adamw_init_shapes(param_shapes(cfg))
        if rules is not None:
            opt = attach_shardings(rules, opt, {"step": (), "master": logical,
                                                "mu": logical, "nu": logical})
    return ps, opt


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec, rules: Optional[AxisRules]):
    b = input_specs(cfg, shape)
    if rules is None:
        return b
    return attach_shardings(rules, b, batch_logical_axes(cfg, shape.kind))


def abstract_cache(cfg: ModelConfig, B: int, S_max: int, rules: Optional[AxisRules]):
    """The serve cache, one dict a layer (the port's layout), as meta
    tensors, placed when rules are given."""
    c = [{k: _meta(shape, dt) for k, (shape, dt) in one.items()}
         for one in cache_shapes(cfg, B, S_max)]
    if rules is None:
        return c
    return attach_shardings(rules, c, cache_logical_axes(cfg))
