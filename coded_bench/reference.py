"""The plain reference: C = A^T B in float64 with one plain PyTorch call.

Exact for the configurations here: every entry, product and partial sum is
an integer below 2**53, so float64 adds them without rounding in any
order.  Nothing of the program under test is imported or read.
"""
from __future__ import annotations

import numpy as np
import torch


def product(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^T B in float64, on the operands' device."""
    return torch.matmul(A.to(torch.float64).T, B.to(torch.float64))


def compare(C: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest absolute gap between an answer and the reference (inf when
    the shapes differ or the answer holds a NaN)."""
    if tuple(C.shape) != tuple(ref.shape):
        return float("inf")
    gap = (C.to(torch.float64) - ref).abs().max().item()
    return float("inf") if gap != gap else float(gap)


def points(kind: str, K: int) -> np.ndarray:
    """K real evaluation points on [-1, 1] of the named family."""
    if kind == "chebyshev":
        return np.cos(np.pi * (2 * np.arange(K) + 1) / (2 * K))
    return np.linspace(-1.0, 1.0, K)


def decode_gain(z: np.ndarray, tau: int, survivor_masks) -> float:
    """Largest row sum of |pinv(V_S)| over the given survivor masks, where
    V_S is the tau-column Vandermonde matrix of the points ``z`` at the
    survivors S: how far a decode from S amplifies rounding.  Used only to
    pick which answers to keep for the comparison."""
    worst = 0.0
    for mask in survivor_masks:
        S = np.flatnonzero(np.asarray(mask))
        V = z[S, None] ** np.arange(tau)[None, :]
        worst = max(worst, float(np.abs(np.linalg.pinv(V)).sum(axis=1).max()))
    return worst
