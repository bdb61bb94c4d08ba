"""Parameter, optimizer, batch and cache sharding rules (logical axes per
leaf), the reference's ``distributed/param_sharding.py``.

The layout implements ZeRO-3-style FSDP + Megatron TP + EP:
  * every weight matrix has one dim on "tp"/"ep" (model axis) and one on
    "fsdp" (data axes) - so params, master copies, and Adam moments are all
    fully sharded across the whole mesh;
  * the reference's scanned stacks carry a leading n_groups dim (never
    sharded); the port's ``LM`` holds one layer a ``Block``, so its leaves
    have no such dim, and a tree in the reference's stacked layout (what
    ``models.param_shapes`` and the checkpoints hold) gets the stacked form;
  * axes that do not divide evenly are dropped (see ``sharding.shard``).

Rules are keyed on the leaf's name, which is unique per layer kind.  An
``LM``'s leaves are its parameters, named as ``named_parameters`` names
them; the last component is the rule's key.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from torch import nn
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.sharding import AxisRules, placements, resolve_spec

__all__ = ["param_logical_axes", "tree_shardings", "tree_specs", "batch_logical_axes",
           "cache_logical_axes", "shard_params"]

# leaf name -> logical axes by rank (excluding any leading stack dim)
_RULES = {
    # embeddings / head
    "table": ("tp", "fsdp"),
    # attention
    "wq": ("fsdp", "tp", None),
    "wk": ("fsdp", "tp", None),
    "wv": ("fsdp", "tp", None),
    "wo": ("tp", None, "fsdp"),
    "bq": ("tp", None),
    "bk": ("tp", None),
    "bv": ("tp", None),
    "q_norm": (None,),
    "k_norm": (None,),
    # mlp
    "w_gate": ("fsdp", "tp"),      # moe (E,d,ff) handled by rank below
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe
    "router": (None, None),
    "sh_gate": ("fsdp", "tp"),
    "sh_up": ("fsdp", "tp"),
    "sh_down": ("tp", "fsdp"),
    # mamba
    "w_in": ("fsdp", "tp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "w_x": ("tp", None),
    "w_dt": (None, "tp"),
    "dt_bias": ("tp",),
    "A_log": ("tp", None),
    "D": ("tp",),
    "w_out": ("tp", "fsdp"),
    # rwkv
    "mu": (None, None),
    "w_r": ("fsdp", "tp"),
    "w_k": ("fsdp", "tp"),
    # cmix w_v is (ff, d); tmix w_v is (d, d_attn) - rank-2 both
    "w_v": ("tp", "fsdp"),
    "w_g": ("fsdp", "tp"),
    "w_o": ("tp", "fsdp"),
    "w_decay_base": ("tp",),
    "w_decay_a": ("fsdp", None),
    "w_decay_b": (None, "tp"),
    "u": ("tp", None),
    "ln_scale": ("tp",),
    # norms
    "scale": (None,),
}

# MoE expert tensors are rank-3 (E, d, ff) / (E, ff, d): E on "ep".
_MOE_RANK3 = {
    "w_gate": ("ep", "fsdp", None),
    "w_up": ("ep", "fsdp", None),
    "w_down": ("ep", None, "fsdp"),
}

Axes = Tuple[Optional[str], ...]


def _leaf_axes(name: str, rank: int, stacked: bool) -> Axes:
    base_rank = rank - (1 if stacked else 0)
    if name in _MOE_RANK3 and base_rank == 3:
        ax = _MOE_RANK3[name]
    elif name in _RULES:
        ax = _RULES[name]
        if len(ax) != base_rank:
            ax = tuple(list(ax)[:base_rank]) + (None,) * max(0, base_rank - len(ax))
    else:
        ax = (None,) * base_rank
    if stacked:
        ax = (None,) + ax
    return ax


def param_logical_axes(params: Any) -> Any:
    """Logical-axis tuples for the parameters.

    An ``LM`` gives ``{parameter name: axes}`` (a layer a block, no stack
    dim); a tree in the reference's layout (a dict with ``blocks``, one
    dict per pattern position whose leaves stack the groups) gives the same
    tree with the stacked form, as the reference's does."""
    if isinstance(params, nn.Module):
        return {name: _leaf_axes(name.rsplit(".", 1)[-1], p.ndim, False)
                for name, p in params.named_parameters()}

    def walk(tree, stacked: bool):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stacked)
            else:
                out[k] = _leaf_axes(k, len(v.shape), stacked)
        return out

    result = {}
    for k, v in params.items():
        if k == "blocks":
            result[k] = tuple(walk(b, True) for b in v)
        else:
            result[k] = walk(v, False)
    return result


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _map(fn, tree: Any, logical: Any) -> Any:
    """``fn(leaf, axes)`` over a tree and its logical axes of one structure
    (an ``LM`` pairs with its name-keyed axes)."""
    if isinstance(tree, nn.Module):
        return {name: fn(p, logical[name]) for name, p in tree.named_parameters()}
    if _is_axes(logical):
        return fn(tree, logical)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], logical[k]) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t, l) for t, l in zip(tree, logical))
    raise TypeError(f"no logical axes for {type(tree).__name__}")


def tree_specs(rules: AxisRules, tree: Any, logical: Any) -> Any:
    """Logical-axis tuples -> the resolved specs (divisibility-checked), the
    ``PartitionSpec`` s of the reference's ``tree_shardings``."""
    return _map(lambda leaf, axes: resolve_spec(rules, tuple(leaf.shape), axes), tree, logical)


def tree_shardings(rules: AxisRules, tree: Any, logical: Any) -> Any:
    """Logical-axis tuples -> DTensor placements (divisibility-checked), one
    per mesh dimension, in the tree's structure."""
    return _map(lambda leaf, axes: placements(
        rules.mesh, resolve_spec(rules, tuple(leaf.shape), axes)), tree, logical)


def shard_params(params: nn.Module, rules: AxisRules) -> nn.Module:
    """Place every parameter of ``params`` on the rules' mesh, IN PLACE: each
    becomes a DTensor laid out by its logical axes (each rank keeps its
    shard of the value it holds; every rank must hold the same values).
    Returns ``params``."""
    where = tree_shardings(rules, params, param_logical_axes(params))
    for name, p in list(params.named_parameters()):
        prefix, key = name.rsplit(".", 1)
        placed = distribute_tensor(p.detach(), rules.mesh, where[name], src_data_rank=None)
        setattr(params.get_submodule(prefix), key,
                nn.Parameter(placed, requires_grad=p.requires_grad))
    return params


def batch_logical_axes(cfg, kind: str) -> Dict[str, Axes]:
    """Logical axes for the input batch dicts."""
    if kind == "train":
        if cfg.input_mode == "tokens":
            return {"tokens": ("dp", None), "labels": ("dp", None)}
        axes = {"embeds": ("dp", "sp", None), "labels": ("dp", None)}
        if cfg.pos == "mrope":
            axes["pos_ids"] = (None, "dp", None)
        return axes
    if kind == "prefill":
        if cfg.input_mode == "tokens":
            axes = {"tokens": ("dp", None)}
        else:
            axes = {"embeds": ("dp", "sp", None)}
            if cfg.pos == "mrope":
                axes["pos_ids"] = (None, "dp", None)
        return axes
    if kind == "decode":
        if cfg.input_mode == "tokens":
            axes = {"tokens": ("dp", None)}
        else:
            axes = {"embeds": ("dp", None, None)}
            if cfg.pos == "mrope":
                axes["pos_ids"] = (None, "dp", None)
        return axes
    raise ValueError(kind)


def _layer_cache_axes(mixer: str) -> Dict[str, Axes]:
    if mixer in ("attn", "attn_local"):
        return {"k": ("dp", "sp", None, None), "v": ("dp", "sp", None, None)}
    if mixer == "mamba":
        return {"conv": ("dp", None, "tp"), "ssm": ("dp", "tp", None)}
    if mixer == "rwkv":
        return {"shift_t": ("dp", None), "shift_c": ("dp", None),
                "wkv": ("dp", "tp", None, None)}
    raise ValueError(mixer)


def cache_logical_axes(cfg) -> list:
    """Logical axes for the serve cache, one dict a layer (the port's
    per-layer cache, ``models.cache_shapes``; the reference's stacked
    entries carry a leading None for the group)."""
    return [_layer_cache_axes(mixer) for _ in range(cfg.n_groups) for mixer, _ in cfg.pattern]

