"""Coding schemes for distributed matmul C = A^T B.

Three schemes, all expressed in one algebraic frame.  Each block of A gets a
monomial  s^(s_exp) * z^(z_exp)  and likewise for B; worker k receives the
linear combinations evaluated at z_k and computes the product of its two
coded blocks.  The worker-output polynomial in z has degree tau-1, so ANY
tau workers determine all coefficients (Vandermonde interpolation).  Useful
blocks C_ij sit at known z-powers; for the bounded-entry schemes they are
superposed with interference terms at nonzero powers of the (large) base s
and are recovered by digit extraction (round + mod s).

Schemes
-------
EntangledBoundedScheme   (paper Sec. III-B) : tau = m*n           (optimal)
TradeoffScheme           (paper Sec. IV)    : tau = m*n*p' + p'-1 (p' | p)
PolynomialCodeYu         (baseline [Yu et al. 2018]): tau = p*m*n + p - 1

Notes
-----
* TradeoffScheme with p'=1 coincides with EntangledBoundedScheme up to the
  (immaterial) sign of the s exponents; with p'=p it degenerates to a pure
  polynomial code with tau = m*n*p + p - 1 and NO digit superposition.
* Paper Sec. IV states the useful z-power as m*p'*j + p'*i + p - 1; the
  derivation (and the paper's own Example 1) gives p' - 1, which is what we
  implement (verified: Example 1 useful powers z^1,z^3,z^5,z^7).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.partition import GridSpec

__all__ = [
    "Scheme",
    "EntangledBoundedScheme",
    "TradeoffScheme",
    "PolynomialCodeYu",
    "make_scheme",
]


@dataclasses.dataclass(frozen=True)
class Scheme:
    """Base: geometry + exponent tables.

    Subclasses fill in:
      a_z_exp, a_s_exp : (p, m) int arrays - monomial exponents per A block
      b_z_exp, b_s_exp : (p, n) int arrays - monomial exponents per B block
    """

    grid: GridSpec

    # ---- to be overridden -------------------------------------------------
    @property
    def tau(self) -> int:
        raise NotImplementedError

    def a_exponents(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def b_exponents(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def useful_z_exp(self) -> np.ndarray:
        """(m, n) int array: z-power carrying C_ij."""
        raise NotImplementedError

    @property
    def digit_depth(self) -> int:
        """Interference occupies s-digits -digit_depth..+digit_depth (0=C)."""
        raise NotImplementedError

    # ---- shared -----------------------------------------------------------
    @property
    def degree(self) -> int:
        return self.tau - 1

    @property
    def needs_digit_extraction(self) -> bool:
        return self.digit_depth > 0

    def max_abs_X(self, L: float, s: float) -> float:
        """Bound on |X_ij| (interpolated coefficient) given entry-product
        bound L (every C entry and every interference product < L) and base s.

        |X| <= sum_{d=-D..D} (L-1) s^d  <  L * s^D * (1 + 2/(s-1))  ~ L s^D.
        With s = 2L this is the paper's (2L)^{p/p'} / 2 up to the tiny
        negative-digit tail.
        """
        D = self.digit_depth
        return float((L - 1) * sum(float(s) ** d for d in range(-D, D + 1)))

    def encode_coeffs(self, z_points: np.ndarray, s: float):
        """Dense encoding coefficient tensors.

        Returns (coeff_a, coeff_b):
          coeff_a : (K, p, m)  with  coeff_a[k,u,i] = s^a_s[u,i] * z_k^a_z[u,i]
          coeff_b : (K, p, n)  likewise.
        Complex z yields complex coefficients.
        """
        az, asx = self.a_exponents()
        bz, bsx = self.b_exponents()
        z = np.asarray(z_points)[:, None, None]  # (K,1,1)
        sf = float(s)
        coeff_a = (sf ** asx.astype(np.float64))[None] * z ** az[None]
        coeff_b = (sf ** bsx.astype(np.float64))[None] * z ** bz[None]
        return coeff_a, coeff_b


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EntangledBoundedScheme(Scheme):
    """Paper Sec. III-B.  tau = m*n (optimal).

    A~(s,z) = sum_i z^i     sum_u A_ui s^{-u}
    B~(s,z) = sum_j z^{m j} sum_v B_vj s^{+v}
    C_ij is the s^0 digit of the z^{m j + i} coefficient.
    """

    @property
    def tau(self) -> int:
        g = self.grid
        return g.m * g.n

    def a_exponents(self):
        g = self.grid
        u = np.arange(g.p)[:, None]
        i = np.arange(g.m)[None, :]
        z_exp = np.broadcast_to(i, (g.p, g.m)).copy()
        s_exp = np.broadcast_to(-u, (g.p, g.m)).copy()
        return z_exp, s_exp

    def b_exponents(self):
        g = self.grid
        v = np.arange(g.p)[:, None]
        j = np.arange(g.n)[None, :]
        z_exp = np.broadcast_to(g.m * j, (g.p, g.n)).copy()
        s_exp = np.broadcast_to(v, (g.p, g.n)).copy()
        return z_exp, s_exp

    def useful_z_exp(self):
        g = self.grid
        i = np.arange(g.m)[:, None]
        j = np.arange(g.n)[None, :]
        return (g.m * j + i).astype(np.int64)

    @property
    def digit_depth(self) -> int:
        return self.grid.p - 1


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TradeoffScheme(Scheme):
    """Paper Sec. IV.  p' | p.  tau = m*n*p' + p' - 1, digits +-(p/p' - 1).

    A block (u_row, i):  u_row = k + (p/p') j,  j < p', k < p/p'
        -> z^{j + p' i} s^{k}
    B block (v_row, u):  v_row = w + (p/p') v,  v < p', w < p/p'
        -> z^{m p' u + (p' - 1 - v)} s^{-w}
    C_iu is the s^0 digit of z^{m p' u + p' i + p' - 1}.
    """

    p_prime: int = 1

    def __post_init__(self):
        if self.grid.p % self.p_prime != 0:
            raise ValueError(f"p'={self.p_prime} must divide p={self.grid.p}")

    @property
    def tau(self) -> int:
        g = self.grid
        return g.m * g.n * self.p_prime + self.p_prime - 1

    def a_exponents(self):
        g, pp = self.grid, self.p_prime
        q = g.p // pp  # p / p'
        u = np.arange(g.p)[:, None]
        i = np.arange(g.m)[None, :]
        j = u // q
        k = u % q
        z_exp = np.broadcast_to(j + pp * i, (g.p, g.m)).copy()
        s_exp = np.broadcast_to(k, (g.p, g.m)).copy()
        return z_exp, s_exp

    def b_exponents(self):
        g, pp = self.grid, self.p_prime
        q = g.p // pp
        vrow = np.arange(g.p)[:, None]
        u = np.arange(g.n)[None, :]
        v = vrow // q
        w = vrow % q
        z_exp = np.broadcast_to(g.m * pp * u + (pp - 1 - v), (g.p, g.n)).copy()
        s_exp = np.broadcast_to(-w, (g.p, g.n)).copy()
        return z_exp, s_exp

    def useful_z_exp(self):
        g, pp = self.grid, self.p_prime
        i = np.arange(g.m)[:, None]
        u = np.arange(g.n)[None, :]
        return (g.m * pp * u + pp * i + pp - 1).astype(np.int64)

    @property
    def digit_depth(self) -> int:
        return self.grid.p // self.p_prime - 1


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PolynomialCodeYu(Scheme):
    """Baseline of [Yu, Maddah-Ali, Avestimehr 2018].  tau = p*m*n + p - 1.

    A~(z) = sum_{u,i} A_ui z^{u + p i}
    B~(z) = sum_{v,j} B_vj z^{(p-1-v) + p m j}
    Every A_ui^T B_vj lands on a distinct z-power; C_ij (= sum over u=v) is
    the coefficient of z^{p - 1 + p i + p m j}.  No digit extraction.
    """

    @property
    def tau(self) -> int:
        g = self.grid
        return g.p * g.m * g.n + g.p - 1

    def a_exponents(self):
        g = self.grid
        u = np.arange(g.p)[:, None]
        i = np.arange(g.m)[None, :]
        z_exp = (u + g.p * i).astype(np.int64)
        s_exp = np.zeros((g.p, g.m), dtype=np.int64)
        return z_exp, s_exp

    def b_exponents(self):
        g = self.grid
        v = np.arange(g.p)[:, None]
        j = np.arange(g.n)[None, :]
        z_exp = ((g.p - 1 - v) + g.p * g.m * j).astype(np.int64)
        s_exp = np.zeros((g.p, g.n), dtype=np.int64)
        return z_exp, s_exp

    def useful_z_exp(self):
        g = self.grid
        i = np.arange(g.m)[:, None]
        j = np.arange(g.n)[None, :]
        return (g.p - 1 + g.p * i + g.p * g.m * j).astype(np.int64)

    @property
    def digit_depth(self) -> int:
        return 0


# ---------------------------------------------------------------------------
def make_scheme(kind: str, p: int, m: int, n: int, p_prime: int = 1) -> Scheme:
    grid = GridSpec(p=p, m=m, n=n)
    if kind in ("bec", "entangled", "bounded"):
        return EntangledBoundedScheme(grid)
    if kind == "tradeoff":
        return TradeoffScheme(grid, p_prime=p_prime)
    if kind in ("polycode", "yu", "baseline"):
        return PolynomialCodeYu(grid)
    raise ValueError(f"unknown scheme kind {kind!r}")
