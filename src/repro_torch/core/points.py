"""Evaluation points z_1..z_K for the coded matmul polynomials.

The paper (Sec. V) uses K equally spaced reals in [-1, 1] and notes that
real Vandermonde systems are badly conditioned; complex points on the unit
circle give error that is "identically zero" at the cost of complex
arithmetic.  Beyond the paper we also provide Chebyshev nodes, which keep
real arithmetic but improve the Vandermonde condition number exponentially
over equispaced nodes (standard approximation-theory fact).

Vandermonde families also extend incrementally: appending evaluation
points leaves every existing point's polynomial evaluations (hence every
existing worker's encoded task) unchanged.  :func:`extend_points` grows a
point set by greedy Leja selection — each new point maximises the product
of distances to the points already placed — which keeps the extended
Vandermonde system well conditioned without moving the prefix.  This is
the foundation of the elastic grow path (``distributed/elastic``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_points", "extend_points", "POINT_KINDS"]

POINT_KINDS = ("equispaced", "chebyshev", "unit_circle")


def make_points(kind: str, K: int, dtype=np.float64) -> np.ndarray:
    """Return K distinct evaluation points.

    kind:
      equispaced  - the paper's choice: K equally spaced in [-1, 1].
      chebyshev   - cos((2k+1) pi / (2K)): real, much better conditioned.
      unit_circle - exp(2 pi i k / K): complex, condition number 1 when K
                    points are used (DFT matrix); the paper's zero-error variant.
    """
    if K < 1:
        raise ValueError("K must be >= 1")
    if kind == "equispaced":
        if K == 1:
            pts = np.array([0.5])  # any nonzero point works; stay inside (-1,1)
        else:
            pts = np.linspace(-1.0, 1.0, K)
            # Avoid z=0 exactly when K is odd: 0 is a fine evaluation point for
            # positive-power polynomials, keep the paper's grid as-is.
        return pts.astype(dtype)
    if kind == "chebyshev":
        k = np.arange(K)
        pts = np.cos((2 * k + 1) * np.pi / (2 * K))
        return pts.astype(dtype)
    if kind == "unit_circle":
        k = np.arange(K)
        pts = np.exp(2j * np.pi * k / K)
        return pts.astype(np.complex128 if dtype == np.float64 else np.complex64)
    raise ValueError(f"unknown point kind {kind!r}; options: {POINT_KINDS}")


def extend_points(z, g: int) -> np.ndarray:
    """Extend a point set by ``g`` fresh points; the prefix is untouched.

    Returns a ``(K + g,)`` array whose first K entries are bit-identical
    to ``z`` (same dtype), so every quantity derived per-point — encoding
    coefficients, worker task assignments, cached decode panels for
    old-pool erasure patterns — is unchanged by the extension.

    New points come from greedy Leja selection over a fixed deterministic
    candidate grid (a dense Chebyshev grid in [-1, 1] for real ``z``,
    dense unit-circle roots for complex ``z``): each pick maximises
    ``prod_i |c - z_i|`` over everything already placed, evaluated as a
    sum of logs.  Leja sequences keep the Vandermonde growth factor
    subexponential, so the extended system stays decodable in floating
    point; candidates within ``~100*eps`` of an existing point are
    excluded, so the result is always pairwise distinct.

    Raises:
        ValueError: on a non-1-D/empty ``z``, negative ``g``, or a
            candidate grid too coincident with ``z`` to supply ``g``
            distinct points (never happens for grids this dense unless
            ``z`` itself nearly fills the domain).
    """
    z = np.asarray(z)
    if z.ndim != 1 or z.size < 1:
        raise ValueError(f"need a 1-D non-empty point set, got shape {z.shape}")
    if g < 0:
        raise ValueError(f"g must be >= 0, got {g}")
    if g == 0:
        return z.copy()
    K = z.size
    is_complex = np.iscomplexobj(z)
    M = max(257, 8 * (K + g) + 1)
    if is_complex:
        cand = np.exp(2j * np.pi * np.arange(M) / M)
        current = z.astype(np.complex128)
    else:
        cand = np.cos((2 * np.arange(M) + 1) * np.pi / (2 * M))
        current = z.astype(np.float64)
    tol = 100 * np.finfo(np.float64).eps

    def _log_dist(d: np.ndarray) -> np.ndarray:
        # -inf marks near-coincident candidates out of the running.
        return np.where(d < tol, -np.inf, np.log(np.maximum(d, tol)))

    objective = _log_dist(np.abs(cand[:, None] - current[None, :])).sum(axis=1)
    chosen = []
    for _ in range(g):
        best = int(np.argmax(objective))
        if not np.isfinite(objective[best]):
            raise ValueError(
                f"candidate grid exhausted extending {K} points by {g}")
        chosen.append(cand[best])
        objective = objective + _log_dist(np.abs(cand - cand[best]))
    return np.concatenate([z, np.asarray(chosen).astype(z.dtype)])
