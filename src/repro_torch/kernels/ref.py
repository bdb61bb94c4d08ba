"""Plain PyTorch versions of the kernels' functions.

These are the ground truth the CUDA kernels are held against on the card,
and what the wrappers in ``ops`` run for tensors on the CPU.  Keep them
boring and obviously correct.

Half precision (bf16, f16) in the three coded products follows one
contract, the kernels' and the TPU kernels': every sum is taken in float32
and the result is rounded once to its output dtype.
"""
from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)

__all__ = ["encode_ref", "decode_ref", "decode_partial_ref", "matmul_t_ref",
           "fused_worker_ref", "scan_chunk", "linear_scan", "wkv_chunked",
           "wkv_scan_ref", "mamba_scan_ref"]


def encode_ref(coeff: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """coeff: (K, P), blocks: (P, E) -> (K, E).

    The encode stage of the coded matmul: worker k's coded block is the
    coefficient-weighted sum of all P = p*m (or p*n) source blocks, in the
    coefficient dtype.  bf16/f16 coefficients: the sums are taken in
    float32 and rounded once to the coefficient dtype.
    """
    if coeff.dtype in _HALF:
        return (coeff.float() @ blocks.float()).to(coeff.dtype)
    return coeff @ blocks.to(coeff.dtype)


def decode_ref(W: torch.Tensor, Y: torch.Tensor, s: float,
               extract: bool = True) -> torch.Tensor:
    """W: (mn, tau) useful rows of the inverse Vandermonde; Y: (tau, E)
    survivor outputs -> (mn, E) decoded C blocks.

    X = W @ Y, then the paper's Sec. III-C extraction: round -> mod s in
    [0, s) -> recentre to (-s/2, s/2]; ``extract=False`` only rounds (the
    baseline polynomial code).  Complex X contributes its real part.
    """
    X = W @ Y.to(W.dtype)
    if X.is_complex():
        X = X.real
    R = torch.round(X)
    if not extract:
        return R
    C_hat = torch.remainder(R, s)
    return torch.where(C_hat <= s / 2, C_hat, C_hat - s)


def decode_partial_ref(W_stack: torch.Tensor, Y: torch.Tensor, s: float,
                       extract: bool = True, bounds=None) -> torch.Tensor:
    """Per-chunk decode: chunk q's outputs through chunk q's panel.

    W_stack: (Q, mn, K).  With ``bounds=None``, Y is (Q, K, Ec) and the
    result (Q, mn, Ec), one :func:`decode_ref` per chunk, stacked.  With
    ``bounds`` (Q + 1 column offsets), Y is (K, E) as the runtime holds it,
    chunk q is columns ``bounds[q]:bounds[q + 1]``, and the result is the
    (mn, E) decode with every chunk in place.
    """
    Q = W_stack.shape[0]
    if bounds is None:
        return torch.stack([decode_ref(W_stack[q], Y[q], s, extract)
                            for q in range(Q)])
    return torch.cat([decode_ref(W_stack[q], Y[:, bounds[q]:bounds[q + 1]],
                                 s, extract) for q in range(Q)], dim=1)


def fused_worker_ref(coeff_a: torch.Tensor, coeff_b: torch.Tensor,
                     a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """coeff_a: (K, P), coeff_b: (K, Q), a_blocks: (*grid_a, v, r),
    b_blocks: (*grid_b, v, t) -> (K, r, t); the leading block dims flatten
    row-major to P (resp. Q).

    The fused encode+product stage: worker k's output is
    Y_k = (sum_P ca[k,P] A_P)^T (sum_Q cb[k,Q] B_Q), staged explicitly here
    (coded matrices materialised) as ground truth for the kernel.

    bf16/f16: each coded matrix is summed in float32 and ROUNDED ONCE to the
    input dtype before the product (as the staged ``encode_ref`` then
    ``matmul_t_ref`` would form it); the product accumulates in float32
    and is rounded once to ``out_dtype`` (default: the input dtype).
    """
    dt = coeff_a.dtype
    A = a_blocks.reshape(coeff_a.shape[1], *a_blocks.shape[-2:]).to(dt)
    B = b_blocks.reshape(coeff_b.shape[1], *b_blocks.shape[-2:]).to(dt)
    if dt in _HALF:
        a_tilde = torch.einsum("kp,pvr->kvr", coeff_a.float(), A.float()).to(dt)
        b_tilde = torch.einsum("kq,qvt->kvt", coeff_b.float(), B.float()).to(dt)
        Y = torch.einsum("kvr,kvt->krt", a_tilde.float(), b_tilde.float())
        return Y.to(out_dtype or dt)
    a_tilde = torch.einsum("kp,pvr->kvr", coeff_a, A)
    b_tilde = torch.einsum("kq,qvt->kvt", coeff_b, B)
    Y = torch.einsum("kvr,kvt->krt", a_tilde, b_tilde)
    return Y.to(out_dtype or dt)


def matmul_t_ref(A: torch.Tensor, B: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """A: (v, r), B: (v, t) -> A^T @ B: (r, t) - one worker's task.
    bf16/f16 accumulate in float32, rounded once to ``out_dtype`` (default:
    the input dtype)."""
    acc = torch.float32 if A.dtype in _HALF else A.dtype
    out = A.to(acc).T @ B.to(acc)
    return out.to(out_dtype or A.dtype)


# ---------------------------------------------------------------------------
# the two recurrences of the LM substrate


def scan_chunk(S: int, chunk: int) -> int:
    """The chunk length the scans use for a sequence of length S: ``chunk``
    capped at S, halved until it divides S (as the reference's kernels and
    chunked paths pick it)."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Inclusive scan of (decay, update) pairs along dim 1 under
    ``(al, bl) o (ar, br) = (al * ar, bl * ar + br)``: returns
    (A_cum, B_cum) with B_cum[:, t] the state after step t from a zero
    state and A_cum[:, t] the product of the decays up to t.

    The reference evaluates this with ``lax.associative_scan`` (a tree of
    combines); here it is a loop over the steps, so the two agree to float32
    rounding, not bit for bit.  ``a`` broadcasts against ``b``.  Autograd
    runs through it (no ``out=`` writes).
    """
    A_cum, B_cum = [a[:, 0]], [b[:, 0]]
    for t in range(1, b.shape[1]):
        A_cum.append(A_cum[-1] * a[:, t])
        B_cum.append(torch.addcmul(b[:, t], B_cum[-1], a[:, t]))
    return torch.stack(A_cum, 1), torch.stack(B_cum, 1)


def wkv_chunked(w, k, v, r, u, S0, chunk: int) -> tuple:
    """RWKV-6 WKV by chunks, as ``models/rwkv6.py::_wkv_chunked`` of the
    reference computes it, plus the chunk-entry states.

    w, k, r: (B, S, H, dk) f32 (w the per-step decay in (0, 1)); v: (B, S,
    H, dv); u: (H, dk); S0: (B, H, dk, dv) initial state.
        S_t = diag(w_t) S_{t-1} + k_t^T v_t
        y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    Returns y (B, S, H, dv), the final state (B, H, dk, dv) and the state at
    the entry of every chunk (B, nc, H, dk, dv).
    """
    B, S, H, dk = k.shape
    dv = v.shape[-1]
    chunk = scan_chunk(S, chunk)
    nc = S // chunk
    y = torch.empty((B, S, H, dv), dtype=torch.float32, device=k.device)
    bounds = torch.empty((B, nc, H, dk, dv), dtype=torch.float32, device=k.device)
    state = S0
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        bounds[:, c] = state
        a = w[:, sl, ..., None]                               # (B,c,H,dk,1)
        b = k[:, sl, ..., None] * v[:, sl, :, None, :]        # (B,c,H,dk,dv)
        A_cum, B_cum = linear_scan(a, b)
        # state BEFORE step t: the inclusive scan shifted right by one
        A_prev = torch.cat([torch.ones_like(A_cum[:, :1]), A_cum[:, :-1]], dim=1)
        B_prev = torch.cat([torch.zeros_like(B_cum[:, :1]), B_cum[:, :-1]], dim=1)
        S_prev = A_prev * state[:, None] + B_prev
        eff = S_prev + u[None, None, :, :, None] * b
        y[:, sl] = torch.einsum("bchk,bchkv->bchv", r[:, sl], eff)
        state = A_cum[:, -1] * state + B_cum[:, -1]
    return y, state, bounds


def wkv_scan_ref(w, k, v, r, u, chunk: int = 64) -> tuple:
    """Plain version of the WKV kernel: zero initial state, the kernel's
    chunking.  Returns (y (B,S,H,dv), S_fin (B,H,dk,dv), S_bounds
    (B,nc,H,dk,dv)) in float32."""
    B, _, H, dk = k.shape
    S0 = torch.zeros((B, H, dk, v.shape[-1]), dtype=torch.float32, device=k.device)
    return wkv_chunked(w, k, v, r, u, S0, chunk)


def mamba_scan_ref(dt, x, Bm, Cm, A_log, D, chunk: int = 128) -> tuple:
    """Plain version of the selective-scan kernel, step by step as the
    reference's ``kernels/ref.py::mamba_scan_ref``, plus the chunk-entry
    states at the kernel's chunking.

    dt, x: (B, S, d) f32; Bm, Cm: (B, S, s) f32; A_log: (d, s); D: (d,).
        h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   A = -exp(A_log)
        y_t = h_t . C_t + D x_t
    Returns (y (B,S,d), h_fin (B,d,s), h_bounds (B,nc,d,s)), zero initial
    state.  Autograd runs through it.
    """
    Bsz, S, d = dt.shape
    s = A_log.shape[1]
    chunk = scan_chunk(S, chunk)
    A = -torch.exp(A_log)
    h = torch.zeros((Bsz, d, s), dtype=torch.float32, device=dt.device)
    ys, bounds = [], []
    for t in range(S):
        if t % chunk == 0:
            bounds.append(h)
        dt_t, x_t = dt[:, t], x[:, t]
        a = torch.exp(dt_t[:, :, None] * A[None])
        h = a * h + (dt_t * x_t)[:, :, None] * Bm[:, t, None, :]
        ys.append(torch.sum(h * Cm[:, t, None, :], -1) + D[None] * x_t)
    return torch.stack(ys, 1), h, torch.stack(bounds, 1)
