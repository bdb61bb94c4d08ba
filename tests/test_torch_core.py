"""The PyTorch port's plan math against the JAX reference package.

Plan tables, decode panels, point sets and bounds are host numpy in both
packages and must be EXACTLY equal; tensor functions (block split, digit
extraction, interpolation, encode) are compared on the same numpy inputs.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import bounds as jbounds  # noqa: E402
from repro.core import decoding as jdec  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core import points as jpoints  # noqa: E402
from repro.core import vandermonde as jvander  # noqa: E402
from repro.runtime import CodedMatmul as JCodedMatmul  # noqa: E402
from repro_torch.core import api, bounds, decoding, numerics, partition, points  # noqa: E402
from repro_torch.core import vandermonde  # noqa: E402
from repro_torch.core.schemes import make_scheme  # noqa: E402
from repro_torch.runtime import CodedMatmul  # noqa: E402

# (kind, p, m, n, p_prime) - one geometry per scheme family.
SCHEMES = [
    ("bec", 2, 2, 2, 1),
    ("tradeoff", 4, 2, 1, 2),
    ("polycode", 2, 2, 1, 1),
]
POINTS = ["equispaced", "chebyshev", "unit_circle"]


def _plans(kind, p, m, n, pp, points="chebyshev", L=1000):
    """The same plan from both packages, with K = tau + 2 workers."""
    K = make_scheme(kind, p, m, n, p_prime=pp).tau + 2
    kw = dict(p_prime=pp, points=points)
    return (japi.make_plan(kind, p, m, n, K=K, L=L, **kw),
            api.make_plan(kind, p, m, n, K=K, L=L, **kw))


def _assert_same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("points", POINTS)
@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_plan_tables_equal(kind, p, m, n, pp, points):
    jp, tp = _plans(kind, p, m, n, pp, points=points, L=7 * 9 + 1)
    for field in ("z_points", "coeff_a", "coeff_b"):
        _assert_same_array(getattr(jp, field), getattr(tp, field))
    assert jp.s == tp.s and jp.K == tp.K and jp.tau == tp.tau
    assert jp.is_complex == tp.is_complex == (points == "unit_circle")
    assert (tp.scheme.digit_depth, tp.scheme.needs_digit_extraction) == (
        jp.scheme.digit_depth, jp.scheme.needs_digit_extraction)
    _assert_same_array(jp.scheme.useful_z_exp(), tp.scheme.useful_z_exp())


@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_plan_from_arrays_carries_a_jax_plan(rng, kind, p, m, n, pp):
    """A JAX plan's fields, carried across as plain values, give exactly the
    port's own plan, and both packages then compute the same C."""
    v, r, t = 8 * p, 12, 10
    L = v * 3 * 3 + 1
    jp, tp = _plans(kind, p, m, n, pp, points="equispaced", L=L)
    carried = api.plan_from_arrays(
        kind, p, m, n, pp, jp.K, jp.s, np.asarray(jp.z_points),
        np.asarray(jp.coeff_a), np.asarray(jp.coeff_b))
    for field in ("z_points", "coeff_a", "coeff_b"):
        _assert_same_array(getattr(carried, field), getattr(tp, field))
    assert (carried.scheme, carried.K, carried.s) == (tp.scheme, tp.K, tp.s)
    A = rng.integers(-3, 4, size=(v, r)).astype(np.float64)
    B = rng.integers(-3, 4, size=(v, t)).astype(np.float64)
    C_j = np.asarray(JCodedMatmul(jp, "fused")(jnp.asarray(A), jnp.asarray(B),
                                               erased=[1]))
    C_t = _np(CodedMatmul(carried, device="cpu")(A, B, erased=[1]))
    np.testing.assert_array_equal(C_t, C_j)
    np.testing.assert_array_equal(C_t, A.T @ B)


def test_plan_from_arrays_rejects_bad_shapes():
    jp, _ = _plans("bec", 2, 2, 2, 1)
    with pytest.raises(ValueError, match="do not match"):
        api.plan_from_arrays("bec", 2, 2, 2, 1, jp.K + 1, jp.s, jp.z_points,
                             jp.coeff_a, jp.coeff_b)


@pytest.mark.parametrize("points", POINTS)
@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_decode_panels_equal(kind, p, m, n, pp, points):
    jp, tp = _plans(kind, p, m, n, pp, points=points)
    jc, tc = jp.make_panel_cache(), tp.make_panel_cache()
    K = tp.K
    masks = [np.ones(K), np.r_[0.0, np.ones(K - 1)], np.r_[np.ones(K - 2), 0, 0],
             np.r_[1.0, 0.0, np.ones(K - 3), 0.0]]
    for mask in masks:
        jw, tw = jc.get(mask), tc.get(mask)
        _assert_same_array(jw.W, tw.W)
        _assert_same_array(jw.mask, tw.mask)
    assert jc.builds == tc.builds == len(masks)
    tc.get(masks[0])
    assert tc.builds == len(masks)
    with pytest.raises(ValueError, match="survivors"):
        tc.get(np.r_[1.0, np.zeros(K - 1)])


@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_panel_cache_extended(kind, p, m, n, pp):
    jp, tp = _plans(kind, p, m, n, pp)
    jc, tc = jp.make_panel_cache(), tp.make_panel_cache()
    K = tp.K
    for mask in (np.ones(K), np.r_[0.0, np.ones(K - 1)]):
        jc.get(mask)
        tc.get(mask)
    z_new = points.extend_points(tp.z_points, 3)
    _assert_same_array(z_new, jpoints.extend_points(jp.z_points, 3))
    jx, tx = jc.extended(z_new), tc.extended(z_new)
    assert tx.builds == 0 and set(tx._panels) == set(jx._panels)
    for key, panel in tx._panels.items():
        _assert_same_array(panel.W, jx._panels[key].W)
        _assert_same_array(panel.mask, jx._panels[key].mask)
    # a carried panel is the one a fresh factorisation of the grown pool gives
    fresh = decoding.make_decode_panel(tp.scheme, z_new, np.r_[np.ones(K), 0, 0, 0])
    np.testing.assert_allclose(tx.get(np.r_[np.ones(K), 0, 0, 0]).W, fresh.W,
                               rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="extend"):
        tc.extended(z_new[1:])


@pytest.mark.parametrize("v,r,rows,cols", [(8, 6, 2, 3), (9, 7, 2, 2),
                                           (16, 12, 4, 1), (5, 3, 1, 1)])
def test_block_decompose_roundtrip(rng, v, r, rows, cols):
    x = rng.normal(size=(v, r))
    jb = np.asarray(jpart.block_decompose(jnp.asarray(x), rows, cols))
    tb = partition.block_decompose(torch.as_tensor(x), rows, cols)
    np.testing.assert_array_equal(_np(tb), jb)
    back = partition.unpad(partition.block_recompose(tb), (v, r))
    np.testing.assert_array_equal(_np(back), x)
    np.testing.assert_array_equal(
        _np(partition.pad_to_multiple(torch.as_tensor(x), (rows, cols))),
        np.asarray(jpart.pad_to_multiple(jnp.asarray(x), (rows, cols))))


def test_block_decompose_is_a_view_without_padding():
    x = torch.arange(8 * 6, dtype=torch.float64).reshape(8, 6)
    blocks = partition.block_decompose(x, 2, 3)
    assert blocks.data_ptr() == x.data_ptr() and not blocks.is_contiguous()


@pytest.mark.parametrize("L", [1, 2, 3, 100, 1000, 2 ** 20 + 1, 12345.5])
@pytest.mark.parametrize("pow2", [True, False])
def test_choose_s(L, pow2):
    assert bounds.choose_s(L, pow2) == jbounds.choose_s(L, pow2)


def test_bounds_grid():
    """is_safe, max_abs_coefficient and plan_p_prime on a small grid."""
    for p, m, n in [(2, 2, 2), (4, 2, 1), (6, 1, 2), (8, 2, 2)]:
        for L in (10, 1000, 10 ** 5, 10 ** 7):
            for dtype in ("float64", "float32", np.float32):
                for slack in (0.0, 4.0):
                    got = bounds.plan_p_prime(p, m, n, L, dtype,
                                              conditioning_slack_bits=slack)
                    exp = jbounds.plan_p_prime(p, m, n, L, dtype,
                                               conditioning_slack_bits=slack)
                    assert dataclasses.asdict(got) == dataclasses.asdict(exp)
                    s = bounds.choose_s(L)
                    for depth in range(3):
                        assert bounds.is_safe(L, s, depth, dtype, tau=m * n,
                                              conditioning_slack_bits=slack) \
                            == jbounds.is_safe(L, s, depth, dtype, tau=m * n,
                                               conditioning_slack_bits=slack)
                        assert bounds.max_abs_coefficient(L, s, depth) == \
                            jbounds.max_abs_coefficient(L, s, depth)
    assert bounds.conservative_L(100, 15, 15) == jbounds.conservative_L(100, 15, 15)
    assert bounds.mantissa_bits(torch.float64) == 53
    assert bounds.mantissa_bits(torch.float32) == 24


def test_paper_configuration_bounds():
    """The paper's 8000^2 geometry is unsafe at entry bound 50 and safe at 15
    by the 4-bit conditioning slack, in both packages."""
    for entry, safe in ((50, False), (15, True)):
        L = 8000 * entry * entry + 1
        s = bounds.choose_s(L)
        args = (L, s, 1, "float64")
        assert bounds.is_safe(*args, tau=4) == jbounds.is_safe(*args, tau=4) == safe


@pytest.mark.parametrize("s", [2.0 ** 4, 2.0 ** 10, 2.0 ** 26])
def test_digit_extract_equal(rng, s):
    half = s / 2
    specials = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 7.5, -7.5,
                         half, -half, half + 0.5, -half - 0.5, half - 0.5,
                         -half + 0.5, half + 1, -half - 1, s, -s, s - 0.5,
                         3 * s + 2.5, -3 * s - 2.5, 0.0, -0.0])
    X = np.concatenate([specials, rng.normal(scale=4 * s, size=200),
                        np.round(rng.normal(scale=4 * s, size=200)) + 0.5])
    got = _np(decoding.digit_extract(torch.as_tensor(X), s))
    exp = np.asarray(jdec.digit_extract(jnp.asarray(X), s))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("complex_points", [False, True])
def test_extend_points_equal(complex_points):
    z = points.make_points("unit_circle" if complex_points else "chebyshev", 6)
    for g in (0, 1, 5):
        _assert_same_array(points.extend_points(z, g), jpoints.extend_points(z, g))
    for kind in POINTS:
        _assert_same_array(points.make_points(kind, 7), jpoints.make_points(kind, 7))


@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_extend_and_shrink_plan_equal(kind, p, m, n, pp):
    jp, tp = _plans(kind, p, m, n, pp)
    for jx, tx in ((japi.extend_plan(jp, 2), api.extend_plan(tp, 2)),
                   (japi.shrink_plan(jp, [0, 2, 3, 4, 5]),
                    api.shrink_plan(tp, [0, 2, 3, 4, 5]))):
        assert jx.K == tx.K
        for field in ("z_points", "coeff_a", "coeff_b"):
            _assert_same_array(getattr(jx, field), getattr(tx, field))
    with pytest.raises(ValueError, match="tau"):
        api.shrink_plan(tp, [0])


@pytest.mark.parametrize("points_kind", ["chebyshev", "unit_circle"])
def test_interpolation_matches_reference(rng, points_kind):
    z = points.make_points(points_kind, 7)
    tau = 4
    Y = rng.normal(size=(7, 3, 5))
    mask = np.array([1, 0, 1, 1, 0, 1, 1], dtype=np.float64)
    got = _np(vandermonde.interpolate_masked(
        torch.as_tensor(z), torch.as_tensor(Y), torch.as_tensor(mask), tau))
    exp = np.asarray(jvander.interpolate_masked(
        jnp.asarray(z), jnp.asarray(Y), jnp.asarray(mask), tau))
    np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-9)
    got = _np(vandermonde.interpolate_solve(torch.as_tensor(z[:tau]),
                                            torch.as_tensor(Y[:tau])))
    exp = np.asarray(jvander.interpolate_solve(jnp.asarray(z[:tau]),
                                               jnp.asarray(Y[:tau])))
    np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-9)
    _assert_same_array(vandermonde.vandermonde(z, tau), jvander.vandermonde(z, tau))
    np.testing.assert_array_equal(vandermonde.inverse_vandermonde(z[:tau]),
                                  jvander.inverse_vandermonde(z[:tau]))


@pytest.mark.parametrize("kind,p,m,n,pp", SCHEMES)
def test_encode_products_and_decode_match_reference(rng, kind, p, m, n, pp):
    """Staged encode + products agree to rounding; every decode path then
    recovers exactly the reference's integer C."""
    v, r, t = 8 * p, 12, 10
    jp, tp = _plans(kind, p, m, n, pp, L=v * 9 + 1)
    A = rng.integers(-3, 4, size=(v, r)).astype(np.float64)
    B = rng.integers(-3, 4, size=(v, t)).astype(np.float64)
    g = tp.scheme.grid
    ab = partition.block_decompose(torch.as_tensor(A), g.p, g.m)
    bb = partition.block_decompose(torch.as_tensor(B), g.p, g.n)
    Y = api.worker_products(*api.encode_blocks(tp, ab, bb))
    jY = japi.worker_products(*japi.encode_blocks(
        jp, jpart.block_decompose(jnp.asarray(A), g.p, g.m),
        jpart.block_decompose(jnp.asarray(B), g.p, g.n)))
    np.testing.assert_allclose(_np(Y), np.asarray(jY), rtol=1e-10,
                               atol=1e-10 * float(np.abs(jY).max()))
    np.testing.assert_allclose(_np(api.fused_worker_products(tp, ab, bb)),
                               np.asarray(jY), rtol=1e-10,
                               atol=1e-10 * float(np.abs(jY).max()))
    C_blocks = np.asarray(jpart.block_decompose(jnp.asarray(A.T @ B), g.m, g.n))
    mask = np.ones(tp.K)
    mask[[0, 3]] = 0
    Ym = Y * torch.as_tensor(mask)[:, None, None]
    panel = tp.make_panel_cache().get(mask)
    z = torch.as_tensor(tp.z_points)
    for got in (decoding.decode_with_panel(tp.scheme, panel, Ym, tp.s),
                decoding.decode_masked(tp.scheme, z, Ym, torch.as_tensor(mask), tp.s),
                decoding.decode(tp.scheme, z[1:1 + tp.tau], Y[1:1 + tp.tau], tp.s)):
        np.testing.assert_array_equal(_np(got), C_blocks)
    np.testing.assert_array_equal(_np(api.uncoded_matmul(torch.as_tensor(A),
                                                         torch.as_tensor(B))),
                                  np.asarray(japi.uncoded_matmul(jnp.asarray(A),
                                                                 jnp.asarray(B))))


def test_dtype_and_device_policy():
    assert numerics.resolve_dtype(None) == torch.float64
    assert numerics.resolve_dtype("float32") == torch.float32
    assert numerics.resolve_dtype(np.float64) == torch.float64
    assert numerics.resolve_dtype(torch.float32) == torch.float32
    for bad in (torch.bfloat16, "int32", np.complex128):
        with pytest.raises(ValueError, match="not supported"):
            numerics.resolve_dtype(bad)
    assert numerics.complex_dtype(torch.float32) == torch.complex64
    assert numerics.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert numerics.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            numerics.resolve_device()
