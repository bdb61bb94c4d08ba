"""Gradient compression for cross-pod reduction (DESIGN.md Sec. 9).

The paper's digit-stack trick suggests a general principle: exact arithmetic
on scaled integer grids.  Applied to gradient all-reduce, each gradient leaf
is quantised onto an int grid (a shared power-of-two scale chosen from the
global max), the int32 payloads are all-reduced and dequantised: bitwise
deterministic across replicas (no float reduction-order variance), with an
error-feedback residual so the quantisation noise does not bias training.

Trees are nested dicts (or lists and tuples) of tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["quantize_tree", "dequantize_tree", "compressed_psum",
           "error_feedback_update"]


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _scale_for(x: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2.0 ** (bits - 1) - 1
    amax = x.abs().max().to(torch.float32)
    # power-of-two scale: exact multiply/divide in fp, exact across hosts
    exp = torch.ceil(torch.log2(torch.clamp(amax / qmax, min=1e-30)))
    return torch.exp2(exp)


def _quantize(g: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.round(g / s).to(torch.int32)


def quantize_tree(tree: Any, bits: int = 15) -> Tuple[Any, Any]:
    """tree of float32 -> (int32 tree, float32 scale tree).  bits <= 15
    leaves headroom so summing over <= 2^16 replicas cannot overflow int32."""
    scales = _tree_map(lambda g: _scale_for(g, bits), tree)
    return _tree_map(_quantize, tree, scales), scales


def dequantize_tree(q: Any, scales: Any) -> Any:
    """int32 tree and its scales -> float32 tree."""
    return _tree_map(lambda qi, s: qi.to(torch.float32) * s, q, scales)


def compressed_psum(tree: Any, group=None, bits: int = 15) -> Any:
    """Int-grid sum over the ranks of ``group``: quantise -> integer
    all-reduce -> dequantise.

    Exact integer summation makes the result independent of reduction
    order; the scales are synchronised first (a max all-reduce of one
    scalar per leaf).  The reference's ``psum`` inside ``shard_map``.
    """
    def synced_scale(g):
        s = _scale_for(g, bits)
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        return s

    scales = _tree_map(synced_scale, tree)
    q = _tree_map(_quantize, tree, scales)

    def summed(qi):
        dist.all_reduce(qi, op=dist.ReduceOp.SUM, group=group)
        return qi

    return dequantize_tree(_tree_map(summed, q), scales)


def error_feedback_update(grads: Any, residual: Optional[Any],
                          bits: int = 8) -> Tuple[Any, Any]:
    """1-step error feedback: g' = Q(g + r); r' = (g + r) - g'.

    Returns (quantised-dequantised grads, new residual).  The residual keeps
    the long-run bias at zero (the standard EF-SGD argument)."""
    if residual is None:
        residual = _tree_map(torch.zeros_like, grads)
    acc = _tree_map(torch.add, grads, residual)
    q, s = quantize_tree(acc, bits)
    deq = dequantize_tree(q, s)
    return deq, _tree_map(torch.sub, acc, deq)
