"""RWKV-6 WKV scan: the CUDA kernel and its plain version.

Replaces ``src/repro/kernels/wkv_scan.py::wkv_scan_pallas`` (the TPU
kernel).  Per (batch, head), from a zero (dk, dv) state,

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),    S_t = diag(w_t) S_{t-1} + k_t^T v_t

returning y, the final state and the state at every chunk entry
(``csrc/wkv_scan.cu``).

What bounds it on the card: at the RWKV-6 3B prefill (B=4, S=1024, H=48,
dk=dv=64) bytes and FP32 operations each need about 0.09 ms, but the
recurrence is sequential in S, so a kernel is held by one step's latency
times S unless enough warps run beside it, and then by the shared-memory
traffic of feeding w_t, k_t and r_t to every thread.  The columns of the
state are independent: a block owns one (batch, head, group of 32
value columns), splits each column's dk rows over up to 8 threads and
gives each thread those rows of 2 columns (the geometry is
``csrc/wkv_scan.cu``'s own), so the prefill runs 1,536 warps, a thread's
state update is one FMA per row and column, and one shared-memory read of
w_t, k_t, r_t serves two columns.  y_t is summed across the lanes once per
tile from partial sums in shared memory, off the recurrence's path.  Tiles
of w, k, r and v come in with ``cp.async``, double-buffered, 16 bytes at a
time where every pointer allows it (:func:`copy_elems`).

:func:`wkv_scan_ref` (from ``ref``) is the plain version; the wrapper
``ops.wkv_scan`` runs it for CPU tensors and launches the kernel for CUDA
tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import scan_chunk, wkv_scan_ref

__all__ = ["wkv_scan_cuda", "wkv_scan_ref", "copy_elems", "DK_INSTANCES"]

DK_INSTANCES = (8, 16, 32, 64, 128, 256)   # template instances in csrc/wkv_scan.cu

_P, _I = ctypes.c_void_p, ctypes.c_int


def _function():
    fn = _build.load("wkv_scan").repro_wkv_scan_f32
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def copy_elems(dv: int, *addresses: int) -> int:
    """Floats per ``cp.async`` copy: 4 (16 bytes) where every input address
    is a 16-byte multiple and dv a multiple of 4 (dk always is), so every
    staged row starts 16-byte aligned; else 1."""
    return 4 if dv % 4 == 0 and all(a % 16 == 0 for a in addresses) else 1


def _launch(w, k, v, r, u, chunk: int) -> tuple:
    """One launch for dk <= the widest instance: the head width padded with
    zero rows up to the next instance (a zero row of k and r adds nothing
    to y and its state rows stay zero), the padding sliced off the states."""
    B, S, H, dk = k.shape
    dv = v.shape[3]
    inst = min(d for d in DK_INSTANCES if d >= dk)
    if inst != dk:
        w, k, r, u = (F.pad(t, (0, inst - dk)) for t in (w, k, r, u))
    w, k, v, r, u = (t.contiguous() for t in (w, k, v, r, u))
    vec = copy_elems(dv, *(t.data_ptr() for t in (w, k, v, r)))
    y = torch.empty((B, S, H, dv), dtype=torch.float32, device=k.device)
    s_fin = torch.empty((B, H, inst, dv), dtype=torch.float32, device=k.device)
    s_bounds = torch.empty((B, S // chunk, H, inst, dv), dtype=torch.float32,
                           device=k.device)
    stream = torch.cuda.current_stream(k.device).cuda_stream
    err = _function()(w.data_ptr(), k.data_ptr(), v.data_ptr(), r.data_ptr(),
                      u.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
                      s_bounds.data_ptr(), B, S, H, inst, dv, chunk, vec, stream)
    if err != 0:
        raise RuntimeError(f"wkv_scan kernel launch failed: cudaError {err}")
    if inst != dk:
        s_fin, s_bounds = s_fin[:, :, :dk].contiguous(), s_bounds[:, :, :, :dk].contiguous()
    return y, s_fin, s_bounds


def wkv_scan_cuda(w: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  r: torch.Tensor, u: torch.Tensor, chunk: int = 64) -> tuple:
    """Launch the kernel: w, k, r (B, S, H, dk), v (B, S, H, dv), u (H, dk),
    float32 CUDA tensors -> ((y (B, S, H, dv), S_fin (B, H, dk, dv), S_bounds
    (B, nc, H, dk, dv)), the kernel launches made), nc = S / chunk after
    ``chunk`` is capped at S and halved until it divides S.

    Any dk and dv.  The kernel has instances for dk in ``DK_INSTANCES``;
    another dk is padded with zero rows up to the next one, and above the
    widest the state's rows (independent of one another) are scanned in
    groups of that width, a launch each, and their y summed.

    Raises:
        ValueError: on mismatched shapes, devices or dtypes or an empty
            sequence.
        RuntimeError: if the launch fails.
    """
    tensors = (w, k, v, r, u)
    if any(t.dtype != torch.float32 or t.device != k.device for t in tensors) \
            or k.device.type != "cuda":
        raise ValueError("wkv_scan_cuda needs float32 CUDA tensors on one device")
    if k.ndim != 4 or w.shape != k.shape or r.shape != k.shape \
            or v.shape[:3] != k.shape[:3] or u.shape != (k.shape[2], k.shape[3]):
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, r {tuple(r.shape)}, u {tuple(u.shape)}")
    B, S, H, dk = k.shape
    dv = v.shape[3]
    if S < 1 or B * H < 1 or dk < 1 or dv < 1:
        raise ValueError(f"the WKV kernel needs S, B * H, dk, dv >= 1, got S={S}, "
                         f"B={B}, H={H}, dk={dk}, dv={dv}")
    chunk = scan_chunk(S, chunk)
    widest = DK_INSTANCES[-1]
    if dk <= widest:
        return _launch(w, k, v, r, u, chunk), 1
    parts = [_launch(w[..., i:i + widest], k[..., i:i + widest], v, r[..., i:i + widest],
                     u[:, i:i + widest], chunk) for i in range(0, dk, widest)]
    y = parts[0][0]
    for part in parts[1:]:
        y = y + part[0]
    return (y, torch.cat([p[1] for p in parts], dim=2),
            torch.cat([p[2] for p in parts], dim=3)), len(parts)
