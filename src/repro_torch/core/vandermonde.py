"""Vandermonde interpolation utilities for decoding coded matmuls.

Decoding recovers the coefficients X_0..X_{tau-1} of the worker-output
polynomial from evaluations at any tau distinct points.  Two paths on
tensors, plus numpy helpers for host-side set-up:

* ``interpolate_solve`` - direct linear solve of the tau x tau Vandermonde
  system; used for static survivor sets.
* ``interpolate_masked`` - weighted normal equations over ALL K rows with a
  0/1 survivor mask (erased rows may hold garbage), solved with no host
  read of the result, so the mask may be traced.

All paths accept complex points (unit-circle decoding).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "vandermonde",
    "inverse_vandermonde",
    "interpolate_solve",
    "interpolate_masked",
]


def vandermonde(z: np.ndarray, degree_plus_one: int) -> np.ndarray:
    """V[a, d] = z_a ** d, d = 0..degree_plus_one-1 (numpy, setup-time)."""
    z = np.asarray(z)
    d = np.arange(degree_plus_one)
    return z[:, None] ** d[None, :]


def inverse_vandermonde(z: np.ndarray) -> np.ndarray:
    """Explicit inverse of the square Vandermonde at points z via Lagrange
    basis polynomials: row j of V^{-1} holds the coefficients of the j-th
    Lagrange cardinal polynomial.  More accurate than LU for moderate tau.

    Returns W with  X = W @ Y,  W shape (tau, tau):  W[d, a] = coefficient of
    z^d in L_a(z).
    """
    z = np.asarray(z)
    tau = z.shape[0]
    W = np.zeros((tau, tau), dtype=np.result_type(z.dtype, np.float64))
    for a in range(tau):
        # L_a(x) = prod_{b != a} (x - z_b) / prod_{b != a} (z_a - z_b)
        others = np.delete(z, a)
        if others.size:
            coeffs_desc = np.poly(others)  # leading-first coeffs of prod (x - z_b)
            denom = np.prod(z[a] - others)
        else:
            coeffs_desc = np.array([1.0], dtype=W.dtype)
            denom = 1.0
        W[:, a] = coeffs_desc[::-1] / denom
    return W


def _vander(z: torch.Tensor, tau: int) -> torch.Tensor:
    return z[:, None] ** torch.arange(tau, device=z.device)[None, :]


def interpolate_solve(z: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Solve V X = Y for X given square Vandermonde at points z.

    z: (tau,), Y: (tau, ...) -> X: (tau, ...).
    """
    tau = z.shape[0]
    V = _vander(z, tau)
    X = torch.linalg.solve(V, Y.reshape(tau, -1).to(V.dtype))
    return X.reshape(Y.shape)


def interpolate_masked(
    z_all: torch.Tensor, Y_all: torch.Tensor, mask: torch.Tensor, tau: int,
    ridge: float = 0.0,
) -> torch.Tensor:
    """Interpolate from a masked set of evaluations.

    z_all: (K,) all evaluation points; Y_all: (K, ...) all worker outputs
    (garbage rows allowed where mask==0); mask: (K,) 0/1 survivors.
    Requires sum(mask) >= tau.  Solves the weighted normal equations
      (V^H D V) X = V^H D Y,  D = diag(mask),
    which has the exact interpolant as unique solution when >= tau rows
    survive.  ridge adds lambda*I for numerical safety (0 = exact).  The
    solve (LU with partial pivoting) never checks its result on the host,
    as ``jnp.linalg.solve`` does not: fewer than tau survivors give
    non-finite or wrong values, not an error.
    """
    K = z_all.shape[0]
    V = _vander(z_all, tau)                                   # (K, tau)
    Vw = V * mask.to(V.dtype)[:, None]
    G = V.conj().T @ Vw                                       # (tau, tau)
    if ridge:
        G = G + ridge * torch.eye(tau, dtype=G.dtype, device=G.device)
    rhs = Vw.conj().T @ Y_all.reshape(K, -1).to(V.dtype)      # V^H D Y
    X = torch.linalg.solve_ex(G, rhs, check_errors=False)[0]
    return X.reshape((tau,) + tuple(Y_all.shape[1:]))
