"""Property-based tests (hypothesis) of the coding-scheme invariants through
the port: the twin of ``tests/test_property.py``, with its settings.

Invariants checked over randomized geometries and erasure patterns:
  1. exact recovery from any >= tau survivors (unit-circle points);
  2. exponent collision-freedom: useful and interference terms never share
     a (z, s) monomial (the paper's Sec. III-B / IV 'distinctness' claims);
  3. the z-degree equals tau - 1 (threshold = degree + 1);
  4. the digit-extraction bound |sum of negative digits| < 1/2 holds for
     any L and s >= 2L;
  5. encode coefficients are consistent with the exponent tables.
Sweeps 2, 3 and 5 also hold the port's scheme tables equal to the JAX
package's for every geometry drawn.
"""
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the 'test' extra (pip install .[test])")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import make_scheme as jmake_scheme  # noqa: E402
from repro_torch.core import coded_matmul, make_plan, make_scheme, uncoded_matmul  # noqa: E402


def geometries():
    return st.tuples(
        st.integers(1, 4),   # p
        st.integers(1, 3),   # m
        st.integers(1, 3),   # n
    )


@st.composite
def tradeoff_geometries(draw):
    p = draw(st.integers(1, 6))
    divisors = [d for d in range(1, p + 1) if p % d == 0]
    pp = draw(st.sampled_from(divisors))
    m = draw(st.integers(1, 3))
    n = draw(st.integers(1, 3))
    return p, m, n, pp


def _tables_equal(sch, geom):
    p, m, n, pp = geom
    ref = jmake_scheme("tradeoff", p, m, n, p_prime=pp)
    for name in ("a_exponents", "b_exponents"):
        for got, exp in zip(getattr(sch, name)(), getattr(ref, name)()):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))
    np.testing.assert_array_equal(np.asarray(sch.useful_z_exp()), np.asarray(ref.useful_z_exp()))
    assert sch.tau == ref.tau


@settings(max_examples=25, deadline=None)
@given(geometries(), st.integers(0, 2 ** 31 - 1))
def test_bec_exact_recovery_any_survivors(geom, seed):
    p, m, n = geom
    rng = np.random.default_rng(seed)
    v = p * 4
    A = torch.from_numpy(rng.integers(-3, 4, size=(v, m * 3)).astype(np.float64))
    B = torch.from_numpy(rng.integers(-3, 4, size=(v, n * 3)).astype(np.float64))
    L = v * 3 * 3 + 1
    sch = make_scheme("bec", p, m, n)
    K = sch.tau + 3
    plan = make_plan("bec", p, m, n, K=K, L=L, points="unit_circle")
    surv = rng.choice(K, size=sch.tau, replace=False).tolist()
    C = coded_matmul(A, B, plan, survivors=surv, device="cpu")
    np.testing.assert_allclose(C.numpy(), uncoded_matmul(A, B).numpy(), atol=1e-6)


@settings(max_examples=50, deadline=None)
@given(tradeoff_geometries())
def test_exponent_collision_freedom(geom):
    """Useful (z, s=0) monomials are hit ONLY by u=v (depth-matched) pairs."""
    p, m, n, pp = geom
    sch = make_scheme("tradeoff", p, m, n, p_prime=pp)
    _tables_equal(sch, geom)
    az, asx = sch.a_exponents()
    bz, bsx = sch.b_exponents()
    useful = set(map(int, np.asarray(sch.useful_z_exp()).ravel()))
    for ua in range(p):
        for ia in range(m):
            for ub in range(p):
                for jb in range(n):
                    ze = int(az[ua, ia] + bz[ub, jb])
                    se = int(asx[ua, ia] + bsx[ub, jb])
                    if se == 0 and ze in useful:
                        assert ua == ub, (geom, ua, ia, ub, jb)


@settings(max_examples=50, deadline=None)
@given(tradeoff_geometries())
def test_degree_matches_threshold(geom):
    p, m, n, pp = geom
    sch = make_scheme("tradeoff", p, m, n, p_prime=pp)
    _tables_equal(sch, geom)
    az, _ = sch.a_exponents()
    bz, _ = sch.b_exponents()
    assert int(az.max() + bz.max()) == sch.tau - 1
    assert int(np.asarray(sch.useful_z_exp()).max()) <= sch.tau - 1
    assert int(np.asarray(sch.useful_z_exp()).min()) >= 0


@settings(max_examples=50, deadline=None)
@given(st.integers(2, 10), st.integers(2, 40))
def test_negative_digit_tail_below_half(depth, L):
    """Paper Sec. III-C: |sum_{d<0} * s^d| <= (L-1)/(2L-1) < 1/2, at the
    base the port's plans choose for L (never below 2L)."""
    from repro_torch.core.bounds import choose_s
    s = 2 * L
    assert choose_s(L) >= s
    tail = sum((L - 1) * float(s) ** (-d) for d in range(1, depth + 1))
    assert tail < 0.5


@settings(max_examples=30, deadline=None)
@given(tradeoff_geometries(), st.integers(0, 2 ** 31 - 1))
def test_encode_coeffs_match_exponents(geom, seed):
    p, m, n, pp = geom
    sch = make_scheme("tradeoff", p, m, n, p_prime=pp)
    _tables_equal(sch, geom)
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1, 1, size=3)
    s = 8.0
    ca, cb = (np.asarray(c) for c in sch.encode_coeffs(z, s))
    az, asx = sch.a_exponents()
    bz, bsx = sch.b_exponents()
    for k in range(3):
        np.testing.assert_allclose(
            ca[k], (s ** np.asarray(asx).astype(float)) * z[k] ** np.asarray(az), rtol=1e-12)
        np.testing.assert_allclose(
            cb[k], (s ** np.asarray(bsx).astype(float)) * z[k] ** np.asarray(bz), rtol=1e-12)
