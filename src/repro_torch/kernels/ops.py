"""Public wrappers around the CUDA kernels.

Each coded-matmul wrapper promotes dtypes, routes complex operands to the
plain complex PyTorch path (as the reference package routes them to its jnp
oracles: its TPU kernels, like these CUDA kernels, are real-only).  Every
wrapper then dispatches on where the tensors lie: CPU tensors run the
kernel's plain version, CUDA tensors launch the kernel (or raise, on bad
operands only; there is no fallback).  The kernels take every shape their
TPU kernels take; a call may launch its kernel several times (chunk groups,
row or worker slabs, scan row or state groups).  Complex plans (unit-circle
points) take the plain complex path on the card too.

Every wrapper carries an integer ``launches`` count, raised by one for each
launch of its kernel and nowhere else (the ``*_cuda`` functions that may
split a call return the launches they made), so a run can show that its
main path went through the kernels.  The coded product wrappers (encode, matmul_t,
fused_worker) take float64, float32, bfloat16 and float16; bf16/f16
accumulate in float32, as the TPU kernels do.  The two decode wrappers take
float64 and float32, and the two scan wrappers float32 only, as their TPU
kernels do.  Every wrapper also carries the observability hook
:func:`_instrumented`, which does nothing while ``repro_torch.obs`` is off.
A wrapper called while a CUDA stream is being captured launches its
kernel into the graph (and counts that launch once, at capture; replays
are not counted); no wrapper falls back to its plain version then.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.numerics import any_traced
from repro_torch.kernels import ref
from repro_torch.kernels.block_matmul import matmul_t_cuda
from repro_torch.kernels.coded_decode import decode_cuda, decode_partial_cuda
from repro_torch.kernels.coded_encode import encode_cuda
from repro_torch.kernels.coded_fused import fused_worker_cuda
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.wkv_scan import wkv_scan_cuda

__all__ = ["fused_worker", "decode", "decode_partial", "encode", "matmul_t",
           "wkv_scan", "mamba_scan", "launch_counts", "reset_launch_counts"]


def _instrumented(op: str):
    """Kernel timing hook: count every call, time the eager ones.

    While obs is off the wrapper adds one global check and nothing else:
    no event, no synchronize, the same launch counts and results.  While
    it is on, each call counts ``kernel.call{op, traced}``:

    * traced calls (a CUDA stream is being captured, or an argument is a
      fake, functorch-wrapped or ``make_fx``-tracked tensor, as
      ``core.numerics.is_traced`` says) count ``traced=1`` and record no
      span and no event: a captured launch runs at replay;
    * eager calls count ``traced=0`` and record the span ``kernel.<op>`` on
      lane ``kernels``.  With a CUDA tensor among the arguments the call is
      bracketed by a start/stop CUDA event pair on the current stream and
      nothing waits: the span is deferred (``SpanRecorder.defer``),
      parented at launch and closed once the stop event has run, found by
      later launches or at the latest by a read of the recorder.  Under the
      monotonic clock it lies where the card ran the launch; under a
      simulated ``SettableClock`` it starts at the session clock at launch
      and lasts the event-measured DEVICE time.  Otherwise the plain call
      is bracketed by the session clock.
    """
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not obs.enabled():
                return fn(*args, **kwargs)
            if any_traced(args):
                obs.count("kernel.call", op=op, traced=1)
                return fn(*args, **kwargs)
            card = next((a for a in args if isinstance(a, torch.Tensor) and a.is_cuda),
                        None)
            if card is None:
                obs.count("kernel.call", op=op, traced=0)
                with obs.span(f"kernel.{op}", lane="kernels"):
                    return fn(*args, **kwargs)
            # the kernels launch on the current stream of their first
            # operand's device; only what the launch needs comes before it
            device = card.device
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                out = fn(*args, **kwargs)
            finally:
                obs.count("kernel.call", op=op, traced=0)
            stop.record(stream)
            obs.session().recorder.defer(f"kernel.{op}", start, stop, device,
                                         lane="kernels")
            return out
        return inner
    return wrap


def _common_dtype(*tensors: torch.Tensor) -> torch.dtype:
    dt = tensors[0].dtype
    for x in tensors[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix."""
    kinds = {x.device.type for x in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"operands must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


@_instrumented("fused_worker")
def fused_worker(coeff_a: torch.Tensor, coeff_b: torch.Tensor,
                 a_blocks: torch.Tensor, b_blocks: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """All-K fused encode+product: coeff_a (K, P), coeff_b (K, Q),
    a_blocks (*grid_a, v, r), b_blocks (*grid_b, v, t) -> (K, r, t), with the
    leading block dims flattened row-major to P (resp. Q).

    Promotes everything to one dtype (encode semantics).  The kernel masks
    ragged edges itself, so nothing is padded.  Complex operands take the
    plain path wherever they lie.
    """
    tensors = (coeff_a, coeff_b, a_blocks, b_blocks)
    if any(x.is_complex() for x in tensors):
        return ref.fused_worker_ref(coeff_a, coeff_b, a_blocks, b_blocks,
                                    out_dtype)
    dt = _common_dtype(*tensors)
    ca, cb, a, b = (x.to(dt) for x in tensors)
    if not _on_card(*tensors):
        return ref.fused_worker_ref(ca, cb, a, b, out_dtype)
    out, cluster = fused_worker_cuda(ca, cb, a, b, out_dtype)
    fused_worker.launches += 1
    fused_worker.cluster_launches += cluster
    return out


@_instrumented("decode")
def decode(W: torch.Tensor, Y: torch.Tensor, s: float, *,
           extract: bool = True) -> torch.Tensor:
    """W: (mn, tau), Y: (tau, E) -> (mn, E) decoded + digit-extracted
    (``extract=False`` only rounds).  Y is promoted to W's dtype; complex
    panels take the plain path (the real part is extracted)."""
    if W.is_complex() or Y.is_complex():
        return ref.decode_ref(W, Y, s, extract)
    Y = Y.to(W.dtype)
    if not _on_card(W, Y):
        return ref.decode_ref(W, Y, s, extract)
    out, n = decode_cuda(W, Y, s, extract)
    decode.launches += n
    return out


@_instrumented("decode_partial")
def decode_partial(W_stack: torch.Tensor, Y: torch.Tensor, s: float, *,
                   extract: bool = True, bounds=None) -> torch.Tensor:
    """Per-chunk decode with fused digit extraction, one launch for up to
    128 chunks: chunk q's worker outputs through chunk q's panel W_stack[q]
    (Q, mn, K).

    With ``bounds=None``, Y is the (Q, K, Ec) stack of the reference
    package's signature and the result (Q, mn, Ec).  With ``bounds`` (Q + 1
    column offsets from 0 to E), Y is (K, E) as the runtime holds it, chunk
    q is columns ``bounds[q]:bounds[q + 1]`` (widths may differ), and the
    result is the (mn, E) decode.  Y is promoted to W_stack's dtype; complex
    panels take the plain path.
    """
    if W_stack.is_complex() or Y.is_complex():
        return ref.decode_partial_ref(W_stack, Y, s, extract, bounds)
    Y = Y.to(W_stack.dtype)
    if not _on_card(W_stack, Y):
        return ref.decode_partial_ref(W_stack, Y, s, extract, bounds)
    out, n = decode_partial_cuda(W_stack, Y, s, extract, bounds)
    decode_partial.launches += n
    return out


@_instrumented("encode")
def encode(coeff: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Encode: coeff (K, P), blocks (P, E) -> (K, E) coded blocks, as in the
    reference package; or blocks (*grid, rows, cols) with prod(grid) = P,
    possibly a strided view from ``block_decompose``, -> the contiguous
    (K, rows, cols) coded stack.

    Promotes to one dtype; complex operands take the plain path.
    """
    flat = blocks.ndim == 2
    stack = blocks.unsqueeze(1) if flat else blocks
    K, P = coeff.shape
    if coeff.is_complex() or blocks.is_complex():
        out = ref.encode_ref(coeff, stack.reshape(P, -1))
    else:
        dt = _common_dtype(coeff, blocks)
        c, x = coeff.to(dt), stack.to(dt)
        if _on_card(c, x):
            out, n = encode_cuda(c, x)
            encode.launches += n
        else:
            out = ref.encode_ref(c, x.reshape(P, -1))
    return out.reshape(K, -1) if flat else out.reshape(K, *stack.shape[-2:])


@_instrumented("matmul_t")
def matmul_t(A: torch.Tensor, B: torch.Tensor, *, out_dtype=None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One worker's product: A (v, r), B (v, t) -> A^T B (r, t).

    Promotes to one dtype; complex operands take the plain path.  ``out``,
    if given, is a contiguous (r, t) tensor of the result's dtype that
    receives the product (the kernel writes it directly).
    """
    if A.is_complex() or B.is_complex():
        res = ref.matmul_t_ref(A, B, out_dtype)
    else:
        dt = _common_dtype(A, B)
        a, b = A.to(dt), B.to(dt)
        if _on_card(a, b):
            direct = out if out_dtype is None else None
            res = matmul_t_cuda(a, b, direct, out_dtype)
            matmul_t.launches += 1
        else:
            res = ref.matmul_t_ref(a, b, out_dtype)
    if out is None or res is out:
        return res
    return out.copy_(res)


# Kernels 7 and 6 are torch.library custom ops, so a trace under fake or
# meta tensors (launch/dryrun.py) sees one op with the outputs' shapes and
# launches nothing: the CPU implementation is the plain version, the CUDA
# implementation launches the kernel (and counts it), the fake one only
# shapes the outputs.

@torch.library.custom_op(
    "repro_torch::wkv_scan", mutates_args=(), device_types="cpu",
    schema="(Tensor w, Tensor k, Tensor v, Tensor r, Tensor u, int chunk) "
           "-> (Tensor, Tensor, Tensor)")
def _wkv_scan_op(w, k, v, r, u, chunk):
    return ref.wkv_scan_ref(w, k, v, r, u, chunk)


@_wkv_scan_op.register_kernel("cuda")
def _wkv_scan_launch(w, k, v, r, u, chunk):
    out, n = wkv_scan_cuda(w, k, v, r, u, chunk)
    wkv_scan.launches += n
    return out


@_wkv_scan_op.register_fake
def _wkv_scan_shapes(w, k, v, r, u, chunk):
    B, S, H, dk = k.shape
    dv = v.shape[3]
    nc = S // ref.scan_chunk(S, chunk)
    return (v.new_empty((B, S, H, dv), dtype=torch.float32),
            v.new_empty((B, H, dk, dv), dtype=torch.float32),
            v.new_empty((B, nc, H, dk, dv), dtype=torch.float32))


@_instrumented("wkv_scan")
def wkv_scan(w: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             r: torch.Tensor, u: torch.Tensor, *, chunk: int = 64) -> tuple:
    """RWKV-6 WKV scan from a zero state: w, k, r (B, S, H, dk) float32 (w
    the per-step decay in (0, 1)), v (B, S, H, dv), u (H, dk) -> (y (B, S,
    H, dv), S_fin (B, H, dk, dv), S_bounds (B, nc, H, dk, dv)), the states at
    the entries of chunks of ``chunk`` steps (capped at S, halved until it
    divides S).  The custom op ``repro_torch::wkv_scan``."""
    _on_card(w, k, v, r, u)
    return _wkv_scan_op(w, k, v, r, u, chunk)


@torch.library.custom_op(
    "repro_torch::mamba_scan", mutates_args=(), device_types="cpu",
    schema="(Tensor dt, Tensor x, Tensor Bm, Tensor Cm, Tensor A_log, Tensor D, "
           "int chunk) -> (Tensor, Tensor, Tensor)")
def _mamba_scan_op(dt, x, Bm, Cm, A_log, D, chunk):
    return ref.mamba_scan_ref(dt, x, Bm, Cm, A_log, D, chunk)


@_mamba_scan_op.register_kernel("cuda")
def _mamba_scan_launch(dt, x, Bm, Cm, A_log, D, chunk):
    out, n = mamba_scan_cuda(dt, x, Bm, Cm, A_log, D, chunk)
    mamba_scan.launches += n
    return out


@_mamba_scan_op.register_fake
def _mamba_scan_shapes(dt, x, Bm, Cm, A_log, D, chunk):
    B, S, d = x.shape
    s = A_log.shape[1]
    nc = S // ref.scan_chunk(S, chunk)
    return (x.new_empty((B, S, d), dtype=torch.float32),
            x.new_empty((B, d, s), dtype=torch.float32),
            x.new_empty((B, nc, d, s), dtype=torch.float32))


@_instrumented("mamba_scan")
def mamba_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor, *,
               chunk: int = 128) -> tuple:
    """Mamba selective scan from a zero state, ``D`` folded in: dt, x (B, S,
    d) float32 (dt after the softplus), Bm, Cm (B, S, s), A_log (d, s), D
    (d,) -> (y (B, S, d), h_fin (B, d, s), h_bounds (B, nc, d, s)), the
    states at the entries of chunks of ``chunk`` steps (capped at S, halved
    until it divides S).  The custom op ``repro_torch::mamba_scan``."""
    _on_card(dt, x, Bm, Cm, A_log, D)
    return _mamba_scan_op(dt, x, Bm, Cm, A_log, D, chunk)


fused_worker.launches = 0
fused_worker.cluster_launches = 0  # those of its launches in the float64 cluster form
decode.launches = 0
decode_partial.launches = 0
encode.launches = 0
matmul_t.launches = 0
wkv_scan.launches = 0
mamba_scan.launches = 0
_WRAPPERS = {"fused_worker": fused_worker, "decode": decode,
             "decode_partial": decode_partial, "encode": encode,
             "matmul_t": matmul_t, "wkv_scan": wkv_scan,
             "mamba_scan": mamba_scan}


CLUSTER_LAUNCHES = "fused_worker.cluster_launches"


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``, and under
    ``CLUSTER_LAUNCHES`` how many of ``fused_worker``'s took its float64
    cluster form (``coded_fused.clustered``)."""
    counts = {name: fn.launches for name, fn in _WRAPPERS.items()}
    counts[CLUSTER_LAUNCHES] = fused_worker.cluster_launches
    return counts


def reset_launch_counts() -> None:
    """Set every wrapper's launch counts to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
    fused_worker.cluster_launches = 0
