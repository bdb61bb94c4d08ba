"""Block decomposition of matrices for coded distributed matmul.

The paper partitions A (v x r) into a p x m grid and B (v x t) into a p x n
grid of equal-size blocks.  Workers store one (coded) block of each.

``block_decompose`` returns a strided VIEW when no padding is needed: the
fused kernel takes per-block offsets and a row stride, so the blocks are
never copied into a (p*m, bv, br) stack.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "GridSpec",
    "pad_to_multiple",
    "block_decompose",
    "block_recompose",
    "unpad",
]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Grid geometry for one coded matmul C = A^T B.

    A is split p x m (rows: contraction dim v, cols: output rows r).
    B is split p x n (rows: contraction dim v, cols: output cols t).
    C = A^T B is m x n blocks of (r/m x t/n).
    """

    p: int
    m: int
    n: int

    def __post_init__(self):
        if self.p < 1 or self.m < 1 or self.n < 1:
            raise ValueError(f"invalid grid {self}")

    @property
    def num_a_blocks(self) -> int:
        return self.p * self.m

    @property
    def num_b_blocks(self) -> int:
        return self.p * self.n

    @property
    def num_c_blocks(self) -> int:
        return self.m * self.n


def pad_to_multiple(x: torch.Tensor, multiples: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad a 2-D tensor so each dim is a multiple of ``multiples``."""
    v, r = x.shape
    mv, mr = multiples
    pv = (-v) % mv
    pr = (-r) % mr
    if pv == 0 and pr == 0:
        return x
    return F.pad(x, (0, pr, 0, pv))


def block_decompose(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(v, r) -> (rows, cols, v/rows, r/cols) view.  Pads with zeros if needed.

    Zero padding is exact for the coding schemes: zero blocks contribute zero
    useful and zero interference terms.
    """
    x = pad_to_multiple(x, (rows, cols))
    v, r = x.shape
    bv, br = v // rows, r // cols
    return x.reshape(rows, bv, cols, br).permute(0, 2, 1, 3)


def block_recompose(blocks: torch.Tensor) -> torch.Tensor:
    """(rows, cols, bv, br) -> (rows*bv, cols*br)."""
    rows, cols, bv, br = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(rows * bv, cols * br)


def unpad(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Crop a padded 2-D result back to ``shape``."""
    return x[: shape[0], : shape[1]]
