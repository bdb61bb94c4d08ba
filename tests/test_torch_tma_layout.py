"""The tensor-map layout of the bf16/f16 TMA form of kernel 1, on the CPU.

``coded_fused.tma_layout`` turns a block grid view (*grid, v, x) into the
dimensions, byte strides and per-block coordinates of one tensor map, which
the kernel hands to the Tensor Memory Accelerator.  The card is not needed
to check it: the element a coordinate names, computed from those dimensions
and strides, must be the view's element, at every corner of every block.

The views here are int64 planes of distinct indices laid out with the
element strides a 2-byte tensor would have, so every element is told apart
(bf16 holds distinct integers only up to 256).
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.partition import block_decompose
from repro_torch.kernels import coded_fused
from repro_torch.kernels.coded_fused import TMA_MAX_RANK, tma_layout

ITEMSIZE = 2  # bf16 and f16


def _plane(rows: int, cols: int) -> torch.Tensor:
    return torch.arange(rows * cols, dtype=torch.int64).reshape(rows, cols)


def _views() -> dict:
    A = _plane(80, 64)                        # the paper's A, v x r
    B = _plane(80, 48)                        # the paper's B, v x t
    stack = _plane(3 * 40, 96).reshape(3, 40, 96)
    return {
        "A grid (p, m) = (2, 2)": block_decompose(A, 2, 2),
        "A grid (p, m) = (4, 2)": block_decompose(A, 4, 2),
        "B grid (p, n) = (2, 1)": block_decompose(B, 2, 1),
        "B grid (p, n) = (2, 3)": block_decompose(B, 2, 3),
        "stacked blocks": _plane(5 * 24, 40).reshape(5, 24, 40),
        "column slices of stacked blocks": stack[:, :, 8:72],
        "one block, a column slice": A[:, 16:48],
        "tier grid (4, 2, 1)": block_decompose(A, 4, 2).unsqueeze(2),
    }


VIEWS = list(_views())


def _element(flat: torch.Tensor, offset: int, layout, block: int, vi: int, xi: int) -> int:
    """The element at (x, v) = (xi, vi) of `block`, addressed as TMA
    addresses it: the sum over dimensions of coordinate times byte stride."""
    coord = [xi, *layout.coords[block]]
    coord[layout.v_dim] = vi
    nbytes = sum(c * s for c, s in zip(coord, layout.strides))
    assert nbytes % ITEMSIZE == 0
    return int(flat[offset + nbytes // ITEMSIZE])


@pytest.mark.parametrize("label", VIEWS)
def test_every_corner_is_the_views_element(label):
    view = _views()[label]
    layout = tma_layout(view.shape, view.stride(), ITEMSIZE)
    *_, v, x = view.shape
    blocks = view.reshape(-1, v, x)
    assert len(layout.coords) == blocks.shape[0]
    flat = torch.tensor([], dtype=view.dtype).set_(view.untyped_storage())
    for p, vi, xi in itertools.product(range(blocks.shape[0]), (0, v - 1), (0, x - 1)):
        got = _element(flat, view.storage_offset(), layout, p, vi, xi)
        assert got == int(blocks[p, vi, xi]), (p, vi, xi)


@pytest.mark.parametrize("label", VIEWS)
def test_dimensions_are_a_blocks_and_rise_in_stride(label):
    """Dimension 0 is x at unit stride, dimension v_dim is v: a block's own
    extents, so a box past a block's edge reads zeros, never the
    neighbouring block.  The grid dimensions kept hold every block, none of
    them a dimension of one block; every stride is a 16-byte multiple, and
    the strides rise."""
    view = _views()[label]
    layout = tma_layout(view.shape, view.stride(), ITEMSIZE)
    *_, v, x = view.shape
    assert layout.dims[0] == x and layout.dims[layout.v_dim] == v
    assert len(layout.dims) == len(layout.strides) <= TMA_MAX_RANK
    assert layout.strides[0] == ITEMSIZE
    assert all(s % 16 == 0 for s in layout.strides[1:])
    assert list(layout.strides[1:]) == sorted(layout.strides[1:])
    kept = [n for d, n in enumerate(layout.dims) if d not in (0, layout.v_dim)]
    assert int(np.prod(kept)) == view.reshape(-1, v, x).shape[0]
    assert all(n > 1 for n in kept)


def test_the_paper_grid_is_one_rank_4_map():
    """The main path's A: 2 x 2 blocks of 4000 x 4000 in an 8000^2 bf16
    matrix, as (r, block column, v, block row) with the grid's strides."""
    layout = tma_layout((2, 2, 4000, 4000), (4000 * 8000, 4000, 8000, 1), ITEMSIZE)
    assert layout.dims == (4000, 2, 4000, 2)
    assert layout.strides == (2, 8000, 16000, 64_000_000)
    assert layout.v_dim == 2
    assert layout.coords == ((0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1))


@pytest.mark.parametrize("shape,stride,why", [
    ((4, 30, 7), (210, 7, 1), "16-byte"),          # rows of 14 bytes
    ((3, 32, 16), (521, 16, 1), "16-byte"),        # blocks 1042 bytes apart
    ((4, 16, 8), (0, 8, 1), "16-byte"),            # an expanded (zero-stride) grid
    ((4, 16, 8), (128, 0, 1), "16-byte"),          # an expanded (zero-stride) v
    ((2, 2, 2, 2, 16, 16), (2048, 1024, 512, 256, 16, 1), "rank"),  # rank 6
    ((4, 16, 8), (128, 8, 2), "unit-stride"),      # columns not adjacent
])
def test_what_tma_cannot_describe_is_refused(shape, stride, why):
    with pytest.raises(ValueError, match=why):
        tma_layout(shape, stride, ITEMSIZE)


def test_dimensions_of_one_need_no_stride():
    """A grid dimension of one block is dropped, whatever its stride, and a
    last dimension of width one needs no unit stride."""
    layout = tma_layout((1, 3, 16, 8), (7, 128, 8, 1), ITEMSIZE)
    assert layout.dims == (8, 16, 3) and len(layout.coords) == 3
    assert tma_layout((2, 16, 1), (16, 8, 5), ITEMSIZE).dims == (1, 16, 2)


def test_packed_layout_is_the_kernels_host_array():
    """rank, v_dim, dims[5], strides[5], then four coordinates a block
    (kLayoutHead = 12 in csrc/coded_fused.cu), zero-padded."""
    layout = tma_layout((2, 2, 40, 32), (2560, 32, 64, 1), ITEMSIZE)
    packed = list(coded_fused._packed(layout))
    assert packed[:12] == [4, 2, 32, 2, 40, 2, 0, 2, 64, 128, 5120, 0]
    assert packed[12:] == [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 0]
