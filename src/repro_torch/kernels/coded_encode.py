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
    encode_width,
)
from repro_torch.kernels.ref import encode_ref

__all__ = ["encode_cuda", "encode_ref", "MAX_BLOCKS", "MAX_PANEL_BYTES"]

MAX_BLOCKS = 64              # kMaxBlocks in csrc/coded_encode.cu
MAX_PANEL_BYTES = 48 * 1024  # the (K, P) panel lives in shared memory

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SYMBOLS = {torch.float64: "repro_encode_f64", torch.float32: "repro_encode_f32",
            torch.bfloat16: "repro_encode_bf16", torch.float16: "repro_encode_f16"}


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("coded_encode"), _SYMBOLS[dtype])
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _L, _L, _L, _I, _P]
    fn.restype = _I
    return fn


def encode_cuda(coeff: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: coeff (K, P) and blocks (*grid, rows, cols) with
    prod(grid) = P, CUDA tensors of one real dtype (float64, float32,
    bfloat16 or float16) -> the contiguous (K, rows, cols) coded stack in
    that dtype (bf16/f16 summed in FP32).

    The blocks may be strided views; only the last dimension must be
    unit-stride, else it is made contiguous.

    Raises:
        ValueError: on mismatched shapes, devices or dtypes, more than
            ``MAX_BLOCKS`` blocks, or a panel larger than ``MAX_PANEL_BYTES``.
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
    if P > MAX_BLOCKS:
        raise ValueError(f"the encode kernel takes at most {MAX_BLOCKS} blocks, "
                         f"got P={P}")
    if coeff.numel() * coeff.element_size() > MAX_PANEL_BYTES:
        raise ValueError(f"coefficient panel {tuple(coeff.shape)} exceeds "
                         f"{MAX_PANEL_BYTES} bytes of shared memory")
    out = torch.empty((K, rows, cols), dtype=dtype, device=coeff.device)
    if out.numel() == 0:
        return out
    if P == 0:
        return out.zero_()
    c = coeff.contiguous()
    x = _unit_column_stride(blocks)
    offsets, row_stride = _block_offsets(x)
    width = encode_width(x.element_size(), cols, (x.data_ptr(), offsets, row_stride))
    stream = torch.cuda.current_stream(coeff.device).cuda_stream
    err = _function(dtype)(c.data_ptr(), x.data_ptr(), out.data_ptr(),
                           ctypes.addressof(offsets), K, P, rows, cols,
                           row_stride, width, stream)
    if err != 0:
        raise RuntimeError(f"encode kernel launch failed: cudaError {err}")
    return out
