"""WORKER-PRODUCT stage of the staged backend: the CUDA kernel and its plain
version.

Replaces ``src/repro/kernels/block_matmul.py::matmul_t_pallas`` (the TPU
kernel): one worker's coded block product ``A^T B`` for A (v, r), B (v, t)
(``csrc/block_matmul.cu``).

What bounds it on the card: FP64 operations, 2*v*r*t of them (1.28e11 per
worker at the paper's 8000^2 geometry) against 0.38 GB of operands.  The
float64 / float32 kernel is the main loop it shares with the fused kernel
(``csrc/dmma_gemm.cuh``: a 128x128 output tile per block, FP64 on the
tensor cores with mma.sync m16n8k8, a 4-stage cp.async ring) without the
encode; every edge is zero-filled by the copies.  bf16 and f16 run on the
tensor cores with FP32 accumulators and write the input type (or
float32), rounded to nearest even: with 16-byte aligned operands on the
Hopper main loop of ``csrc/wgmma_gemm.cuh`` (a persistent grid of 128x256
tiles, TMA into a 4-stage ring, wgmma m64n128k16, the instruction and
contraction order of the fused kernel, so fused equals staged bit for
bit), otherwise on mma.sync m16n8k16 with plain 2-byte loads.

:func:`matmul_t_ref` (from ``ref``) is the plain version; the wrapper
``ops.matmul_t`` runs it for CPU tensors and launches the kernel for CUDA
tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.coded_fused import (
    DTYPES,
    _kernel_out_dtype,
    _unit_column_stride,
    _unsupported,
    copy_bytes,
)
from repro_torch.kernels.ref import matmul_t_ref

__all__ = ["matmul_t_cuda", "matmul_t_ref"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (input dtype, output dtype) -> entry point of csrc/block_matmul.cu
_SYMBOLS = {(torch.float64, torch.float64): "repro_matmul_t_f64",
            (torch.float32, torch.float32): "repro_matmul_t_f32",
            (torch.bfloat16, torch.bfloat16): "repro_matmul_t_bf16",
            (torch.bfloat16, torch.float32): "repro_matmul_t_bf16_out_f32",
            (torch.float16, torch.float16): "repro_matmul_t_f16",
            (torch.float16, torch.float32): "repro_matmul_t_f16_out_f32"}


def _function(dtype: torch.dtype, out_dtype: torch.dtype):
    fn = getattr(_build.load("block_matmul"), _SYMBOLS[dtype, out_dtype])
    fn.argtypes = [_P, _P, _P, _L, _L, _L, _L, _L, _I, _P]
    fn.restype = _I
    return fn


def matmul_t_cuda(A: torch.Tensor, B: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  out_dtype=None) -> torch.Tensor:
    """Launch the kernel: A (v, r), B (v, t), CUDA tensors of one real dtype
    (float64, float32, bfloat16 or float16) -> A^T B (r, t) in
    ``out_dtype`` (default: the input dtype).  bf16/f16 accumulate in FP32.

    A and B may have any row stride; a last dimension that is not
    unit-stride is made contiguous.  ``out``, if given, is a contiguous
    (r, t) tensor of the input dtype and device that the kernel writes
    (only without ``out_dtype``).

    Raises:
        ValueError: on mismatched shapes, devices or dtypes, or an unusable
            ``out``.
        NotImplementedError: for other dtypes.
        RuntimeError: if the launch fails.
    """
    dtype = A.dtype
    if dtype not in DTYPES:
        raise _unsupported(dtype, "matmul_t")
    if B.dtype != dtype or B.device != A.device or A.device.type != "cuda":
        raise ValueError("matmul_t_cuda needs CUDA tensors of one dtype")
    if A.ndim != 2 or B.ndim != 2 or A.shape[0] != B.shape[0]:
        raise ValueError(f"shape mismatch: A {tuple(A.shape)}, B {tuple(B.shape)}")
    v, r = A.shape
    t = B.shape[1]
    written = _kernel_out_dtype(dtype, out_dtype)
    if out is None:
        out = torch.empty((r, t), dtype=written, device=A.device)
    elif (out_dtype is not None or out.shape != (r, t) or out.dtype != dtype
          or out.device != A.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({r}, {t}) {dtype} tensor "
                         f"on {A.device}, without out_dtype")
    if out.numel() == 0:
        return out.to(out_dtype or dtype)
    a = _unit_column_stride(A)
    b = _unit_column_stride(B)
    width = copy_bytes(a.element_size(), (a.data_ptr(), (0,), a.stride(0)),
                       (b.data_ptr(), (0,), b.stride(0)))
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _function(dtype, written)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    v, r, t, a.stride(0), b.stride(0), width, stream)
    if err != 0:
        raise RuntimeError(f"matmul_t kernel launch failed: cudaError {err}")
    return out.to(out_dtype or dtype)
