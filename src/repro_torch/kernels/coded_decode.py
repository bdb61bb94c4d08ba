"""Coded-matmul DECODE stage with fused digit extraction: the CUDA kernel and
its plain version.

Replaces ``src/repro/kernels/coded_decode.py::decode_pallas`` (the TPU
kernel).  ``X = W @ Y`` followed in registers by the paper's Sec. III-C
extraction (round half-to-even -> mod s -> recentre into (-s/2, s/2]);
``extract=False`` only rounds (``csrc/coded_decode.cu``).

What bounds it on the card: device-memory bytes.  At the paper's geometry
it reads Y (K=10, E=16e6 float64, 1.28 GB) once and writes C (mn=4, 0.51 GB)
once for only 2*mn*K operations per column.  The kernel streams Y with
coalesced loads, keeps the panel W in shared memory and the mn sums in
registers, so X never reaches device memory.  W, s and the extract flag
are runtime arguments: a new erasure pattern never rebuilds anything.

:func:`decode_ref` (from ``ref``) is the plain version; the wrapper
``ops.decode`` runs it for CPU tensors and launches the kernel for CUDA
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_ref

__all__ = ["decode_cuda", "decode_ref", "MAX_PANEL_BYTES"]

MAX_PANEL_BYTES = 48 * 1024  # the panel lives in (static-limit) shared memory

_SYMBOLS = {torch.float64: "repro_decode_f64", torch.float32: "repro_decode_f32"}


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("coded_decode"), _SYMBOLS[dtype])
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, ctypes.c_longlong, ctypes.c_double, I, P]
    fn.restype = I
    return fn


def decode_cuda(W: torch.Tensor, Y: torch.Tensor, s: float,
                extract: bool = True) -> torch.Tensor:
    """Launch the kernel: W (mn, K), Y (K, E), CUDA tensors of one real dtype
    (float64 or float32) -> (mn, E).

    Raises:
        ValueError: on mismatched shapes, devices or dtypes, or a panel
            larger than ``MAX_PANEL_BYTES``.
        NotImplementedError: for dtypes other than float64 / float32.
        RuntimeError: if the launch fails.
    """
    dtype = W.dtype
    if dtype not in _SYMBOLS:
        raise NotImplementedError(
            f"the decode CUDA kernel takes float64 or float32, not {dtype}")
    if Y.dtype != dtype or Y.device != W.device or W.device.type != "cuda":
        raise ValueError("decode_cuda needs CUDA tensors of one dtype")
    mn, K = W.shape
    K2, E = Y.shape
    if K != K2:
        raise ValueError(f"shape mismatch: W {tuple(W.shape)}, Y {tuple(Y.shape)}")
    if W.numel() * W.element_size() > MAX_PANEL_BYTES:
        raise ValueError(f"decode panel {tuple(W.shape)} exceeds "
                         f"{MAX_PANEL_BYTES} bytes of shared memory")
    out = torch.empty((mn, E), dtype=dtype, device=W.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    Wc = W.contiguous()
    Yc = Y.contiguous()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = _function(dtype)(Wc.data_ptr(), Yc.data_ptr(), out.data_ptr(), mn, K,
                           E, float(s), int(bool(extract)), stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: cudaError {err}")
    return out
