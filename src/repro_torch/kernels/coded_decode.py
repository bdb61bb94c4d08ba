"""Coded-matmul DECODE stage with fused digit extraction: the CUDA kernels and
their plain versions.

:func:`decode_cuda` replaces ``src/repro/kernels/coded_decode.py::
decode_pallas`` (the TPU kernel).  ``X = W @ Y`` followed in registers by the
paper's Sec. III-C extraction (round half-to-even -> mod s -> recentre into
(-s/2, s/2]); ``extract=False`` only rounds (``csrc/coded_decode.cu``).
:func:`decode_partial_cuda` replaces ``decode_partial_pallas``: the same
decode per output-row chunk with chunk q's panel, in one launch for up to
128 chunks, on Y as the runtime holds it (chunks of unequal width) or on the
reference package's equal-width (Q, K, Ec) stack.

What bounds both on the card: device-memory bytes.  At the paper's geometry
they read Y (K=10, E=16e6 float64, 1.28 GB) once and write C (mn=4,
0.51 GB) once for only 2*mn*K operations per column; every row of Y is
read, also one whose panel column is 0, so a NaN there reaches C as in the
reference.  Both keep the panel in shared memory and the mn sums in
registers, so X never reaches device memory.  The decode kernel streams Y
with coalesced loads, a thread a column.  The per-chunk kernel keeps more
bytes in flight: persistent blocks walk one flat list of column tiles over
all chunks, and one thread per block feeds a ring of shared-memory stages
with bulk copies (``cp.async.bulk`` on an mbarrier), which the block reads
16 bytes a thread and turns into 16-byte streaming stores of C.  That form
needs 16-byte aligned addresses and sizes (:func:`bulk_copies` decides it
per launch); otherwise the same tiles and sums run on one-element loads and
stores.  Every output element is the decode kernel's chain of FMAs over k
ascending, so a chunk decodes bit for bit as the decode kernel would.
Panels, s and the extract flag are runtime arguments: a new erasure or
progress pattern never rebuilds anything.

:func:`decode_ref` and :func:`decode_partial_ref` (from ``ref``) are the
plain versions; the wrappers ``ops.decode`` and ``ops.decode_partial`` run
them for CPU tensors and launch the kernels for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_partial_ref, decode_ref

__all__ = ["decode_cuda", "decode_ref", "decode_partial_cuda",
           "decode_partial_ref", "bulk_copies", "MAX_PANEL_BYTES", "MAX_CHUNKS"]

# The panel sits in shared memory: above 48 KB (the default) a launch opts in
# to more, and a panel past the card's per-block limit is decoded in slabs
# of its rows, one launch each (the same sums, so the same bits).
MAX_PANEL_BYTES = 48 * 1024
# Chunks a launch of the per-chunk kernel takes (kMaxChunks in
# csrc/coded_decode.cu); more go in groups of this many, a launch each.
MAX_CHUNKS = 128

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_SYMBOLS = {torch.float64: "repro_decode_f64", torch.float32: "repro_decode_f32"}
_PARTIAL_SYMBOLS = {torch.float64: "repro_decode_partial_f64",
                    torch.float32: "repro_decode_partial_f32"}


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("coded_decode"), _SYMBOLS[dtype])
    fn.argtypes = [_P, _P, _P, _I, _I, _L, _D, _I, _P, _P]
    fn.restype = _I
    return fn


def _partial_function(dtype: torch.dtype):
    fn = getattr(_build.load("coded_decode"), _PARTIAL_SYMBOLS[dtype])
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _L, _L, _D, _I, _I, _P, _P]
    fn.restype = _I
    return fn


def bulk_copies(itemsize: int, addresses, offsets, strides, widths) -> bool:
    """Whether the per-chunk kernel can take its bulk-copy form: every
    data address (bytes) a 16-byte multiple, and every chunk offset, row
    stride and chunk width (elements of ``itemsize`` bytes) 16 bytes wide.
    Else it takes one-element loads and stores."""
    return (all(a % 16 == 0 for a in addresses)
            and all(n * itemsize % 16 == 0 for n in (*offsets, *strides, *widths)))


def _check_operands(W: torch.Tensor, Y: torch.Tensor, what: str) -> None:
    if W.dtype not in _SYMBOLS:
        raise NotImplementedError(
            f"the {what} CUDA kernel takes float64 or float32, not {W.dtype}")
    if Y.dtype != W.dtype or Y.device != W.device or W.device.type != "cuda":
        raise ValueError(f"{what}_cuda needs CUDA tensors of one dtype")


def decode_cuda(W: torch.Tensor, Y: torch.Tensor, s: float,
                extract: bool = True) -> tuple:
    """Launch the kernel: W (mn, K), Y (K, E), CUDA tensors of one real dtype
    (float64 or float32) -> ((mn, E), the kernel launches made).

    Any panel: past the card's shared memory it decodes in slabs of rows,
    a launch each.

    Raises:
        ValueError: on mismatched shapes, devices or dtypes.
        NotImplementedError: for dtypes other than float64 / float32.
        RuntimeError: if the launch fails (one row of K values past the
            card's per-block shared memory, K > 29000 in float64).
    """
    _check_operands(W, Y, "decode")
    dtype = W.dtype
    mn, K = W.shape
    K2, E = Y.shape
    if K != K2:
        raise ValueError(f"shape mismatch: W {tuple(W.shape)}, Y {tuple(Y.shape)}")
    out = torch.empty((mn, E), dtype=dtype, device=W.device)
    if out.numel() == 0 or K == 0:
        return out.zero_(), 0
    Wc = W.contiguous()
    Yc = Y.contiguous()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    launches = ctypes.c_int(0)
    err = _function(dtype)(Wc.data_ptr(), Yc.data_ptr(), out.data_ptr(), mn, K,
                           E, float(s), int(bool(extract)), ctypes.byref(launches), stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: cudaError {err}")
    return out, launches.value


def decode_partial_cuda(W_stack: torch.Tensor, Y: torch.Tensor, s: float,
                        extract: bool = True, bounds=None) -> tuple:
    """Launch the per-chunk kernel for all Q chunks: W_stack (Q, mn, K) and
    Y, CUDA tensors of one real dtype (float64 or float32) -> (the result,
    the kernel launches made).

    With ``bounds=None``, Y is the (Q, K, Ec) stack and the result
    (Q, mn, Ec).  With ``bounds`` (Q + 1 nondecreasing column offsets from 0
    to E), Y is (K, E), chunk q is columns ``bounds[q]:bounds[q + 1]``, and
    the kernel writes the (mn, E) result with every chunk in place.

    Any Q and any panel: chunks go ``MAX_CHUNKS`` to a launch, and a panel
    that leaves no room for the copy ring decodes in slabs of rows (one
    launch per group and slab).

    Raises:
        ValueError: on mismatched shapes, devices or dtypes, or bad bounds.
        NotImplementedError: for dtypes other than float64 / float32.
        RuntimeError: if the launch fails.
    """
    _check_operands(W_stack, Y, "decode_partial")
    dtype = W_stack.dtype
    Q, mn, K = W_stack.shape
    if bounds is None:
        if Y.ndim != 3 or Y.shape[:2] != (Q, K):
            raise ValueError(f"shape mismatch: W_stack {tuple(W_stack.shape)}, "
                             f"Y {tuple(Y.shape)}")
        Ec = Y.shape[2]
        out = torch.empty((Q, mn, Ec), dtype=dtype, device=Y.device)
        y_off = [q * K * Ec for q in range(Q)]
        out_off = [q * mn * Ec for q in range(Q)]
        width = [Ec] * Q
        ys = os_ = Ec
    else:
        bounds = [int(b) for b in bounds]
        if Y.ndim != 2 or Y.shape[0] != K:
            raise ValueError(f"shape mismatch: W_stack {tuple(W_stack.shape)}, "
                             f"Y {tuple(Y.shape)}")
        E = Y.shape[1]
        if (len(bounds) != Q + 1 or bounds[0] != 0 or bounds[-1] != E
                or any(b1 < b0 for b0, b1 in zip(bounds, bounds[1:]))):
            raise ValueError(f"bounds {bounds} do not split {E} columns into "
                             f"{Q} chunks")
        out = torch.empty((mn, E), dtype=dtype, device=Y.device)
        y_off = out_off = bounds[:-1]
        width = [b1 - b0 for b0, b1 in zip(bounds, bounds[1:])]
        ys = os_ = E
    if out.numel() == 0 or K == 0:
        return out.zero_(), 0
    Wc = W_stack.contiguous()
    Yc = Y.contiguous()
    bulk = bulk_copies(Yc.element_size(), (Yc.data_ptr(), out.data_ptr()),
                       (*y_off, *out_off), (ys, os_), width)
    offsets = [(_L * Q)(*x) for x in (y_off, out_off, width)]
    stream = torch.cuda.current_stream(Y.device).cuda_stream
    launches = ctypes.c_int(0)
    err = _partial_function(dtype)(
        Wc.data_ptr(), Yc.data_ptr(), out.data_ptr(), Q, mn, K,
        *(ctypes.addressof(x) for x in offsets), ys, os_, float(s),
        int(bool(extract)), int(bulk), ctypes.byref(launches), stream)
    if err != 0:
        raise RuntimeError(f"decode_partial kernel launch failed: cudaError {err}")
    return out, launches.value
