"""Mamba selective scan: the CUDA kernel and its plain version.

Replaces ``src/repro/kernels/mamba_scan.py::mamba_scan_pallas`` (the TPU
kernel).  Per batch row and channel, from a zero s-wide state,

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + D x_t

with A = -exp(A_log), returning y, the final state and the state at every
chunk entry (``csrc/mamba_scan.cu``).

What bounds it on the card: at the Jamba prefill (B=4, S=1024, d=16384,
s=16) the 0.84 GB it moves need 0.25 ms at the HBM rate, and its 1.07e9
exponentials 0.26 ms on the special-function unit (MUFU.EX2, 16 per clock
per SM at the 1.98 GHz maximum SM clock).  The kernel gives each channel
one thread with its states in registers and takes each exponential as one
``ex2.approx`` on ``dt * A2``, log2(e) folded into ``A2 = -exp(A_log)
log2(e)`` once.  B_t and C_t are read as float4 broadcasts from shared
memory; they and the block's channels of dt and x come in with
``cp.async``, double-buffered, while the block steps through the previous
tile, so the loads hide behind a tile of work.

The reference picks a channel block (``d_blk``, 256 halved until it divides
d) for its VMEM tiles; the outputs do not depend on it, and the CUDA kernel
blocks channels by 64 threads and masks a ragged last block instead.

:func:`mamba_scan_ref` (from ``ref``) is the plain version; the wrapper
``ops.mamba_scan`` runs it for CPU tensors and launches the kernel for CUDA
tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_ref, scan_chunk

__all__ = ["mamba_scan_cuda", "mamba_scan_ref", "S_INSTANCES"]

S_INSTANCES = (4, 8, 16, 32, 64)   # template instances in csrc/mamba_scan.cu
MAX_BATCH = 65535              # the grid's y dimension

_P, _I = ctypes.c_void_p, ctypes.c_int


def _function():
    fn = _build.load("mamba_scan").repro_mamba_scan_f32
    fn.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def _launch(dt, x, Bm, Cm, A_log, D, chunk: int) -> tuple:
    """One launch for s <= the widest instance: the state padded with zero
    columns of B and C up to the next instance (a padded state stays zero
    and adds nothing to y), the padding sliced off the states."""
    B, S, d = x.shape
    s = Bm.shape[2]
    inst = min(n for n in S_INSTANCES if n >= s)
    if inst != s:
        Bm, Cm, A_log = (F.pad(t, (0, inst - s)) for t in (Bm, Cm, A_log))
    dt, x, Bm, Cm, A_log, D = (t.contiguous() for t in (dt, x, Bm, Cm, A_log, D))
    y = torch.empty((B, S, d), dtype=torch.float32, device=x.device)
    h_fin = torch.empty((B, d, inst), dtype=torch.float32, device=x.device)
    h_bounds = torch.empty((B, S // chunk, d, inst), dtype=torch.float32,
                           device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function()(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                      A_log.data_ptr(), D.data_ptr(), y.data_ptr(),
                      h_fin.data_ptr(), h_bounds.data_ptr(), B, S, d, inst, chunk,
                      stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError {err}")
    if inst != s:
        h_fin, h_bounds = h_fin[..., :s].contiguous(), h_bounds[..., :s].contiguous()
    return y, h_fin, h_bounds


def mamba_scan_cuda(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                    chunk: int = 128) -> tuple:
    """Launch the kernel: dt, x (B, S, d), Bm, Cm (B, S, s), A_log (d, s),
    D (d,), float32 CUDA tensors -> ((y (B, S, d), h_fin (B, d, s), h_bounds
    (B, nc, d, s)), the kernel launches made), nc = S / chunk after
    ``chunk`` is capped at S and halved until it divides S.

    Any s.  The kernel has instances for s in ``S_INSTANCES``; another s
    is padded with zero columns of B and C up to the next one, and above the
    widest the states (independent of one another) are scanned in groups of
    that width, a launch each, their y summed (D x in the first group only).

    Raises:
        ValueError: on mismatched shapes, devices or dtypes, more than
            ``MAX_BATCH`` rows or an empty sequence.
        RuntimeError: if the launch fails.
    """
    tensors = (dt, x, Bm, Cm, A_log, D)
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors) \
            or x.device.type != "cuda":
        raise ValueError("mamba_scan_cuda needs float32 CUDA tensors on one device")
    if x.ndim != 3 or dt.shape != x.shape or Bm.ndim != 3 \
            or Bm.shape[:2] != x.shape[:2] or Cm.shape != Bm.shape \
            or A_log.shape != (x.shape[2], Bm.shape[2]) or D.shape != (x.shape[2],):
        raise ValueError(f"shape mismatch: dt {tuple(dt.shape)}, x {tuple(x.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
                         f"A_log {tuple(A_log.shape)}, D {tuple(D.shape)}")
    B, S, d = x.shape
    s = Bm.shape[2]
    if not 1 <= B <= MAX_BATCH or S < 1 or d < 1 or s < 1:
        raise ValueError(f"the selective-scan kernel takes 1 <= B <= {MAX_BATCH}, "
                         f"S >= 1, d >= 1 and s >= 1, got B={B}, S={S}, d={d}, s={s}")
    chunk = scan_chunk(S, chunk)
    widest = S_INSTANCES[-1]
    if s <= widest:
        return _launch(dt, x, Bm, Cm, A_log, D, chunk), 1
    zero_d = torch.zeros_like(D)
    parts = [_launch(dt, x, Bm[..., i:i + widest], Cm[..., i:i + widest],
                     A_log[:, i:i + widest], D if i == 0 else zero_d, chunk)
             for i in range(0, s, widest)]
    y = parts[0][0]
    for part in parts[1:]:
        y = y + part[0]
    return (y, torch.cat([p[1] for p in parts], dim=-1),
            torch.cat([p[2] for p in parts], dim=-1)), len(parts)
