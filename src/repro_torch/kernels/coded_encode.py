"""Coded-matmul ENCODE stage: the CUDA kernel and its plain version.

Replaces ``src/repro/kernels/coded_encode.py::encode_pallas`` (the TPU
kernel).  Worker k's coded block is ``sum_p coeff[k, p] * block_p``, a skinny
(K, P) @ (P, E) product (``csrc/coded_encode.cu``).

What bounds it on the card: device-memory bytes.  At the paper's 8000^2
geometry (P=4, K=10, E=16e6 float64) it reads 0.51 GB and writes 1.28 GB
for about K/8 operations per byte read.  The kernel keeps the (K, P) panel
in shared memory, streams the blocks with coalesced loads and writes the
contiguous (K, rows, cols) coded stack.  The blocks may be the strided views
``block_decompose`` returns: the kernel takes one element offset per block
and the row stride, so nothing is copied into a (P, E) stack first.  bf16
and f16 are summed in FP32 and written in the coefficient dtype, rounded to
nearest even, as the reference's ``out_shape`` is the coefficient dtype.
Where the layout allows (:func:`coded_fused.encode_width`), bf16 and f16
take the 16-byte form: a persistent grid of 16-byte loads and streaming
stores, each element's sum the FP32 chain of kernel 1's encode, so the
staged product equals the fused one bit for bit; else one element a thread.

:func:`encode_ref` (from ``ref``) is the plain version; the wrapper
``ops.encode`` runs it for CPU tensors and launches the kernel for CUDA
tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.coded_fused import (
    DTYPES,
    _block_offsets,
    _unit_column_stride,
    _unsupported,
    device_offsets,
    encode_width,
)
from repro_torch.kernels.ref import encode_ref

__all__ = ["encode_cuda", "encode_ref", "MAX_BLOCKS", "MAX_PANEL_BYTES"]

# Block offsets travel by value up to this many blocks (kMaxBlocks in
# csrc/coded_encode.cu); above it they go through device memory.
MAX_BLOCKS = 64
# The panel sits in shared memory: above 48 KB (the default) the launch opts
# in to more, and a panel past the card's per-block limit is encoded in
# slabs of its K workers, one launch each.
MAX_PANEL_BYTES = 48 * 1024

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SYMBOLS = {torch.float64: "repro_encode_f64", torch.float32: "repro_encode_f32",
            torch.bfloat16: "repro_encode_bf16", torch.float16: "repro_encode_f16"}


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("coded_encode"), _SYMBOLS[dtype])
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _I, _P, _P]
    fn.restype = _I
    return fn


def encode_cuda(coeff: torch.Tensor, blocks: torch.Tensor) -> tuple:
    """Launch the kernel: coeff (K, P) and blocks (*grid, rows, cols) with
    prod(grid) = P, CUDA tensors of one real dtype (float64, float32,
    bfloat16 or float16) -> (the contiguous (K, rows, cols) coded stack in
    that dtype (bf16/f16 summed in FP32), the kernel launches made).

    The blocks may be strided views; only the last dimension must be
    unit-stride, else it is made contiguous.

    Any number of blocks and any panel: above ``MAX_BLOCKS`` blocks their
    offsets reach the kernel through device memory, and a panel past the
    card's shared memory is encoded in slabs of workers (the same sums).

    Raises:
        ValueError: on mismatched shapes, devices or dtypes.
        NotImplementedError: for other dtypes.
        RuntimeError: if the launch fails.
    """
    dtype = coeff.dtype
    if dtype not in DTYPES:
        raise _unsupported(dtype, "encode")
    if blocks.dtype != dtype or blocks.device != coeff.device \
            or coeff.device.type != "cuda":
        raise ValueError("encode_cuda needs CUDA tensors of one dtype")
    K, P = coeff.shape
    *grid, rows, cols = blocks.shape
    if P != math.prod(grid):
        raise ValueError(f"shape mismatch: coeff {tuple(coeff.shape)}, blocks "
                         f"{tuple(blocks.shape)}")
    out = torch.empty((K, rows, cols), dtype=dtype, device=coeff.device)
    if out.numel() == 0:
        return out, 0
    if P == 0:
        return out.zero_(), 0
    c = coeff.contiguous()
    x = _unit_column_stride(blocks)
    offsets, row_stride = _block_offsets(x)
    width = encode_width(x.element_size(), cols, (x.data_ptr(), offsets, row_stride))
    offs = device_offsets(offsets, device=x.device) if P > MAX_BLOCKS else None
    stream = torch.cuda.current_stream(coeff.device).cuda_stream
    launches = ctypes.c_int(0)
    err = _function(dtype)(c.data_ptr(), x.data_ptr(), out.data_ptr(),
                           ctypes.addressof(offsets),
                           None if offs is None else offs.data_ptr(), K, P, rows, cols,
                           row_stride, width, ctypes.byref(launches), stream)
    if err != 0:
        raise RuntimeError(f"encode kernel launch failed: cudaError {err}")
    return out, launches.value
