"""Fused ENCODE + WORKER-PRODUCT stage: the CUDA kernel and its plain version.

Replaces ``src/repro/kernels/coded_fused.py::fused_worker_pallas`` (the
TPU kernel).  For every worker k at once,

    Y_k = (sum_P ca[k, P] * A_P)^T @ (sum_Q cb[k, Q] * B_Q)

from the raw blocks A (P, v, r) and B (Q, v, t); the coded tiles are formed
in shared memory and never reach device memory (``csrc/coded_fused.cu``).

What bounds it on the card: FP64 operations, 2*K*r*t*v (1.28e12 at the
paper's 8000^2 geometry) against about 2.3 GB of operands, so it is
compute-bound, with the raw-tile reads from L2 behind.  The kernel is the
FP64 tensor-core main loop of ``csrc/dmma_gemm.cuh`` (a 128x128 output
tile per block, mma.sync m16n8k8, a 2-stage cp.async ring of raw tiles)
with the encode fused in shared memory, the worker on the grid's fastest
axis; FP32 runs the same ring with CUDA-core FMAs.  In float64, where
:func:`clustered` says so (the main path's shapes), a cluster of 2 x 2
blocks owns a worker's 256x256 super-tile instead: each block encodes
half of one coded A and one coded B tile and stores the halves into the
peer that also needs them through distributed shared memory, with the
same arithmetic and so the same bits.  In bf16 and f16 each
coded tile is the FP32 sum of its raw tiles rounded once to the input
type, the products run on the tensor cores with FP32 accumulators, and
the result is written in the input type (or float32), rounded to nearest
even.  With 16-byte aligned operands (the TMA form) the kernel is the
Hopper main loop of ``csrc/wgmma_gemm.cuh``: a block per output tile and
PAIR of workers, raw tiles brought once for both by TMA through one
tensor map per operand (:func:`tma_layout`), encoded by two consumer
warpgroups that multiply with wgmma; otherwise the one-element form keeps
mma.sync m16n8k16 with plain 2-byte loads.

:func:`fused_worker_ref` (from ``ref``) is the plain version; the wrapper
``ops.fused_worker`` runs it for CPU tensors and launches the kernel for
CUDA tensors.
"""
from __future__ import annotations

import ctypes
import itertools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.numerics import capturing
from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_worker_ref

__all__ = ["fused_worker_cuda", "fused_worker_ref", "copy_bytes", "encode_width",
           "clustered", "tma_layout", "TmaLayout", "TMA_MAX_BLOCKS", "DTYPES",
           "device_offsets"]

# Block offsets travel by value up to this many blocks a side (kMaxBlocks in
# csrc/coded_fused.cu); above it they go through device memory.  It is also
# the TMA form's most blocks: bf16/f16 above it take the one-element form.
TMA_MAX_BLOCKS = 64
TMA_MAX_RANK = 5  # the Tensor Memory Accelerator's largest tensor rank
# The float64 cluster form: at most CLUSTER_MAX_BLOCKS raw blocks a side (one
# group, kGroup in csrc/coded_fused.cu) and more than TILE rows of output
# along both r and t (two tiles or more, so that the 2 x 2 cluster's blocks
# share their coded halves).
CLUSTER_MAX_BLOCKS = 4
TILE = 128
_HALF = (torch.bfloat16, torch.float16)
DTYPES = (torch.float64, torch.float32, *_HALF)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# (input dtype, output dtype) -> entry point of csrc/coded_fused.cu
_SYMBOLS = {(torch.float64, torch.float64): "repro_fused_worker_f64",
            (torch.float32, torch.float32): "repro_fused_worker_f32",
            (torch.bfloat16, torch.bfloat16): "repro_fused_worker_bf16",
            (torch.bfloat16, torch.float32): "repro_fused_worker_bf16_out_f32",
            (torch.float16, torch.float16): "repro_fused_worker_f16",
            (torch.float16, torch.float32): "repro_fused_worker_f16_out_f32"}


def _kernel_out_dtype(dtype: torch.dtype, out_dtype) -> torch.dtype:
    """The dtype a product kernel (1 or 5) writes for inputs of ``dtype``
    when the caller asks for ``out_dtype``: the input dtype, or float32 for
    bf16/f16 inputs whose caller wants anything wider or other than the
    input dtype (the wrapper then converts the FP32 sums once, as the
    reference casts its f32 accumulator)."""
    if dtype in _HALF and out_dtype not in (None, dtype):
        return torch.float32
    return dtype


def _unsupported(dtype: torch.dtype, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {what} CUDA kernel takes float64, float32, bfloat16 or "
        f"float16, not {dtype}")


def _function(dtype: torch.dtype, out_dtype: torch.dtype, cluster: bool = False):
    symbol = "repro_fused_worker_f64_cluster" if cluster else _SYMBOLS[dtype, out_dtype]
    fn = getattr(_build.load("coded_fused"), symbol)
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L,
                   _L, _I, _P]
    fn.restype = _I
    return fn


def _block_offsets(x: torch.Tensor):
    """Element offsets of each (v, r) block of ``x`` (*grid, v, r), in
    row-major grid order, plus the blocks' shared row stride."""
    grid = x.shape[:-2]
    strides = x.stride()[:-2]
    offsets = [sum(i * s for i, s in zip(idx, strides))
               for idx in itertools.product(*(range(g) for g in grid))]
    return (_L * len(offsets))(*offsets), x.stride(-2)


def copy_bytes(itemsize: int, *operands) -> int:
    """The width of the kernels' global-to-shared copies: 16 bytes where
    every operand's data pointer, block offsets and row stride are 16-byte
    multiples, else one element (``itemsize`` bytes).

    Each operand is ``(data_ptr, offsets, row_stride)``: the byte address
    of its storage view, its blocks' offsets and its row stride, both in
    elements.
    """
    for ptr, offsets, row_stride in operands:
        if ptr % 16 or (row_stride * itemsize) % 16 or any(
                (o * itemsize) % 16 for o in offsets):
            return itemsize
    return 16


def encode_width(itemsize: int, cols: int, *operands) -> int:
    """The form of the encode kernel (``csrc/coded_encode.cu``): 16 (16-byte
    loads and stores of 8 elements) for 2-byte elements where ``cols`` is a
    multiple of 8, so that every row of the contiguous (K, rows, cols)
    output starts on 16 bytes, and :func:`copy_bytes` gives 16 for the
    operands; else ``itemsize``, the one-element form (always for float64
    and float32)."""
    if itemsize != 2 or cols % (16 // itemsize):
        return itemsize
    return copy_bytes(itemsize, *operands)


def clustered(dtype: torch.dtype, width: int, P: int, Q: int, r: int, t: int) -> bool:
    """Whether a call of the kernel runs its float64 cluster form (2 x 2
    blocks that split the encode through distributed shared memory): float64
    with 16-byte copies (:func:`copy_bytes`), at most ``CLUSTER_MAX_BLOCKS``
    raw blocks a side, and more than ``TILE`` output rows along both r and t.
    Every other call keeps the tile form (a block a tile; bf16/f16 their TMA
    form): float32, bf16/f16, the one-element copies, more raw blocks (groups
    of them, or offsets in device memory above 64), a single tile along r or
    t."""
    return (dtype == torch.float64 and width == 16 and max(P, Q) <= CLUSTER_MAX_BLOCKS
            and r > TILE and t > TILE)


class TmaLayout(NamedTuple):
    """A block grid (*grid, v, x) as one tensor map of the Tensor Memory
    Accelerator: ``dims`` (elements, innermost first; dimension 0 is x
    within a block, ``v_dim`` is v, the others index the grid), ``strides``
    (bytes, one per dimension; dimension 0's is the element size) and, per
    block in row-major grid order, its coordinates in dimensions
    1..rank-1 (0 at ``v_dim``)."""
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    v_dim: int
    coords: Tuple[Tuple[int, ...], ...]


def _tma_refusal(shape: Sequence[int], strides: Sequence[int],
                 itemsize: int) -> Optional[str]:
    """Why TMA cannot describe this block grid, or None if it can."""
    *grid, v, x = shape
    if x > 1 and strides[-1] != 1:
        return "the last dimension must be unit-stride"
    outer = [strides[-2]] + [s for n, s in zip(grid, strides[:-2]) if n > 1]
    if 1 + len(outer) > TMA_MAX_RANK:
        return (f"a grid of {len(outer) - 1} block dimensions needs rank "
                f"{len(outer) + 1} > {TMA_MAX_RANK}")
    bad = [s for s in outer if s <= 0 or (s * itemsize) % 16]
    if bad:
        return f"stride {bad[0]} of {itemsize}-byte elements is no positive 16-byte multiple"
    return None


def tma_layout(shape: Sequence[int], strides: Sequence[int], itemsize: int) -> TmaLayout:
    """The tensor map of a block grid view of shape (*grid, v, x) with
    element ``strides``: dimension 0 is x (unit stride), then v and every
    grid dimension of more than one block, in increasing stride (grid
    dimensions of one block are dropped).  The map's dimensions are a
    block's, so a box past a block's edge reads zeros, never the
    neighbouring block.

    Raises:
        ValueError: if TMA cannot describe it: a stride that is no positive
            multiple of 16 bytes, more than ``TMA_MAX_RANK`` dimensions, or
            a last dimension that is not unit-stride.
    """
    refusal = _tma_refusal(shape, strides, itemsize)
    if refusal:
        raise ValueError(f"TMA cannot describe the block grid {tuple(shape)} with "
                         f"strides {tuple(strides)}: {refusal}")
    *grid, v, x = shape
    # (stride, size, grid axis or None for v); v first among equal strides
    outer = [(strides[-2], v, None)] + [(s, n, i) for i, (n, s) in
                                        enumerate(zip(grid, strides[:-2])) if n > 1]
    outer.sort(key=lambda e: e[0])
    axes = [axis for _, _, axis in outer]
    coords = tuple(tuple(0 if axis is None else idx[axis] for axis in axes)
                   for idx in itertools.product(*(range(g) for g in grid)))
    return TmaLayout(dims=(x, *(n for _, n, _ in outer)),
                     strides=(itemsize, *(s * itemsize for s, _, _ in outer)),
                     v_dim=1 + axes.index(None), coords=coords)


def _packed(layout: TmaLayout):
    """``layout`` as the kernel's host array (kLayoutHead in
    csrc/coded_fused.cu): rank, v_dim, dims[5], strides[5], then each
    block's coordinates in dimensions 1..4, zero-padded."""
    pad = TMA_MAX_RANK
    head = [len(layout.dims), layout.v_dim,
            *layout.dims, *[0] * (pad - len(layout.dims)),
            *layout.strides, *[0] * (pad - len(layout.strides))]
    body = [c for block in layout.coords for c in (*block, *[0] * (pad - 1 - len(block)))]
    return (_L * (len(head) + len(body)))(*head, *body)


# device_offsets' tensors by (offsets, device).  Kept for the life of the
# process: a CUDA graph captured with one reads it at every replay.  There is
# one entry per block layout above the by-value limit that the process uses.
_DEVICE_OFFSETS: dict = {}


def device_offsets(*offsets, device) -> torch.Tensor:
    """The blocks' element offsets (host arrays, concatenated) as an int64
    tensor on ``device``, for a kernel that takes more blocks than its
    by-value argument holds.  Uploaded at the first call with these offsets
    and kept, so a later call (or one being captured into a CUDA graph)
    copies nothing from the host.

    Raises:
        RuntimeError: for offsets not seen yet while a CUDA stream is being
            captured (a capture cannot copy from the host).
    """
    flat = tuple(o for arr in offsets for o in arr)
    key = (flat, torch.device(device))
    table = _DEVICE_OFFSETS.get(key)
    if table is None:
        if capturing():
            raise RuntimeError(
                "these block offsets are not on the device yet and a CUDA graph "
                "capture cannot copy them from the host: run the same call once "
                "eagerly before capturing it")
        table = _DEVICE_OFFSETS[key] = torch.tensor(flat, dtype=torch.int64).to(device)
    return table


def _unit_column_stride(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 or x.shape[-1] == 1 else x.contiguous()


def fused_worker_cuda(coeff_a: torch.Tensor, coeff_b: torch.Tensor,
                      a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                      out_dtype=None, *, cluster: Optional[bool] = None,
                      ) -> Tuple[torch.Tensor, bool]:
    """Launch the kernel: coeff_a (K, P), coeff_b (K, Q), a_blocks
    (*grid_a, v, r), b_blocks (*grid_b, v, t), all CUDA tensors of one real
    dtype (float64, float32, bfloat16 or float16) -> ((K, r, t) in
    ``out_dtype`` (default: the input dtype), whether the launch took the
    float64 cluster form).  bf16/f16 accumulate in FP32.  ``cluster`` None
    takes the form :func:`clustered` gives; False the tile form (a block a
    tile) whatever the call: the card's tests hold the cluster form to it.

    The blocks may be strided views (e.g. from ``block_decompose``); only
    the last dimension must be unit-stride, else it is made contiguous.
    Above ``TMA_MAX_BLOCKS`` blocks a side the offsets reach the kernel
    through device memory, and bf16/f16 take the one-element form.

    Raises:
        ValueError: on mismatched shapes, devices or dtypes.
        NotImplementedError: for other dtypes.
        RuntimeError: if the launch fails, e.g. with so many blocks that
            their offsets and coefficients leave no room for the ring in the
            card's shared memory (about 1900 a side in float64).
    """
    tensors = (coeff_a, coeff_b, a_blocks, b_blocks)
    dtype = coeff_a.dtype
    if dtype not in DTYPES:
        raise _unsupported(dtype, "fused")
    if any(x.dtype != dtype or x.device != coeff_a.device for x in tensors):
        raise ValueError("fused_worker_cuda needs one dtype and one device")
    if coeff_a.device.type != "cuda":
        raise ValueError("fused_worker_cuda needs CUDA tensors")
    K, P = coeff_a.shape
    K2, Q = coeff_b.shape
    *grid_a, v, r = a_blocks.shape
    *grid_b, v2, t = b_blocks.shape
    if K != K2 or v != v2 or P != math.prod(grid_a) or Q != math.prod(grid_b):
        raise ValueError(f"shape mismatch: coeff_a {tuple(coeff_a.shape)}, "
                         f"coeff_b {tuple(coeff_b.shape)}, a_blocks "
                         f"{tuple(a_blocks.shape)}, b_blocks {tuple(b_blocks.shape)}")
    written = _kernel_out_dtype(dtype, out_dtype)
    out = torch.empty((K, r, t), dtype=written, device=coeff_a.device)
    if out.numel() == 0:
        return out.to(out_dtype or dtype), False
    ca = coeff_a.contiguous()
    cb = coeff_b.contiguous()
    a = _unit_column_stride(a_blocks)
    b = _unit_column_stride(b_blocks)
    a_off, a_sv = _block_offsets(a)
    b_off, b_sv = _block_offsets(b)
    itemsize = a.element_size()
    width = copy_bytes(itemsize, (a.data_ptr(), a_off, a_sv), (b.data_ptr(), b_off, b_sv))
    a_tma = b_tma = None
    many = max(P, Q) > TMA_MAX_BLOCKS
    offs = device_offsets(a_off, b_off, device=a.device) if many else None
    if dtype in _HALF and width == 16:
        # the TMA form where TMA can describe both grids, else one element
        if many or any(_tma_refusal(x.shape, x.stride(), itemsize) for x in (a, b)):
            width = itemsize
        else:
            a_tma, b_tma = (_packed(tma_layout(x.shape, x.stride(), itemsize))
                            for x in (a, b))
    if cluster is None:
        cluster = clustered(dtype, width, P, Q, r, t)
    stream = torch.cuda.current_stream(coeff_a.device).cuda_stream
    err = _function(dtype, written, cluster)(
        ca.data_ptr(), cb.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        ctypes.addressof(a_off), ctypes.addressof(b_off),
        None if offs is None else offs.data_ptr(),
        None if a_tma is None else ctypes.addressof(a_tma),
        None if b_tma is None else ctypes.addressof(b_tma), K, P, Q, v, r, t,
        a_sv, b_sv, width, stream)
    if err != 0:
        raise RuntimeError(f"fused_worker kernel launch failed: cudaError {err}")
    return out.to(out_dtype or dtype), cluster
