"""Plain PyTorch versions of the kernels' functions.

These are the ground truth the CUDA kernels are held against on the card,
and what the wrappers in ``ops`` run for tensors on the CPU.  Keep them
boring and obviously correct.
"""
from __future__ import annotations

import torch

__all__ = ["encode_ref", "decode_ref", "decode_partial_ref", "matmul_t_ref",
           "fused_worker_ref"]


def encode_ref(coeff: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """coeff: (K, P), blocks: (P, E) -> (K, E).

    The encode stage of the coded matmul: worker k's coded block is the
    coefficient-weighted sum of all P = p*m (or p*n) source blocks.
    """
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
    """
    dt = coeff_a.dtype
    A = a_blocks.reshape(coeff_a.shape[1], *a_blocks.shape[-2:]).to(dt)
    B = b_blocks.reshape(coeff_b.shape[1], *b_blocks.shape[-2:]).to(dt)
    a_tilde = torch.einsum("kp,pvr->kvr", coeff_a, A)
    b_tilde = torch.einsum("kq,qvt->kvt", coeff_b, B)
    Y = torch.einsum("kvr,kvt->krt", a_tilde, b_tilde)
    return Y.to(out_dtype or dt)


def matmul_t_ref(A: torch.Tensor, B: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """A: (v, r), B: (v, t) -> A^T @ B: (r, t) - one worker's task."""
    low = A.dtype in (torch.bfloat16, torch.float16)
    acc = torch.float32 if low else A.dtype
    out = A.to(acc).T @ B.to(acc)
    return out.to(out_dtype or A.dtype)
