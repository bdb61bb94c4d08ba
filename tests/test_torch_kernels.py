"""The port's kernel wrappers (plain versions, on the CPU) against the JAX
package's kernels (Pallas in interpret mode, as its own tests run them).

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
What surrounds them - block offsets, strides, dtype promotion, complex
routing, launch counting - is Python and is tested here.
"""
import math

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.kernels.wkv_scan import wkv_scan_pallas  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import api, partition  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    block_matmul,
    coded_decode,
    coded_encode,
    coded_fused,
    mamba_scan,
    ops,
    ref,
    wkv_scan,
)

TOL = {np.float32: 1e-4, np.float64: 1e-10}  # sums taken in another order
RTOL = {np.float32: 1e-5, np.float64: 1e-12}  # one short sum in another order


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(autouse=True)
def _launch_counts():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("K,P,Q,v,r,t", [
    (4, 4, 4, 256, 128, 128),
    (6, 8, 2, 300, 200, 150),     # ragged, non-tile-multiple
    (3, 1, 1, 64, 40, 24),
    (1, 5, 3, 129, 257, 65),      # off-by-one everywhere
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_worker_matches_jax(rng, K, P, Q, v, r, t, dtype):
    x = dict(ca=rng.normal(size=(K, P)), cb=rng.normal(size=(K, Q)),
             a=rng.normal(size=(P, v, r)), b=rng.normal(size=(Q, v, t)))
    x = {k: a.astype(dtype) for k, a in x.items()}
    got = _np(ops.fused_worker(*(torch.as_tensor(x[k]) for k in ("ca", "cb", "a", "b"))))
    exp = np.asarray(jops.fused_worker(*(jnp.asarray(x[k]) for k in ("ca", "cb", "a", "b"))))
    assert got.dtype == exp.dtype == dtype and got.shape == (K, r, t)
    assert np.max(np.abs(got - exp)) / (np.max(np.abs(exp)) + 1e-9) < TOL[dtype]
    assert not any(ops.launch_counts().values())


def test_fused_worker_empty_contraction_is_zero(rng):
    ca, cb = torch.ones(2, 3), torch.ones(2, 1)
    out = ops.fused_worker(ca, cb, torch.ones(3, 0, 5), torch.ones(1, 0, 4))
    assert out.shape == (2, 5, 4) and not out.any()


def test_fused_worker_promotes_dtypes(rng):
    ca = torch.as_tensor(rng.normal(size=(2, 3)), dtype=torch.float32)
    cb = torch.as_tensor(rng.normal(size=(2, 2)))
    a = torch.as_tensor(rng.normal(size=(3, 8, 5)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(2, 8, 4)), dtype=torch.float32)
    out = ops.fused_worker(ca, cb, a, b)
    assert out.dtype == torch.float64
    assert ops.fused_worker(ca, cb.float(), a, b, out_dtype=torch.float64).dtype \
        == torch.float64


def test_fused_worker_complex_routes_to_plain(rng):
    ca = rng.normal(size=(3, 2)) + 1j * rng.normal(size=(3, 2))
    cb = rng.normal(size=(3, 2)) + 1j * rng.normal(size=(3, 2))
    A = rng.normal(size=(2, 32, 16))
    B = rng.normal(size=(2, 32, 8))
    got = _np(ops.fused_worker(*map(torch.as_tensor, (ca, cb, A, B))))
    exp = np.asarray(jops.fused_worker(*map(jnp.asarray, (ca, cb, A, B))))
    np.testing.assert_allclose(got, exp, rtol=1e-10)


@pytest.mark.parametrize("v,r,rows,cols", [(16, 12, 2, 2), (9, 7, 2, 2), (12, 8, 4, 2)])
def test_block_offsets_address_every_block(rng, v, r, rows, cols):
    """The kernel's addressing - base pointer + per-block offset + row stride
    + unit column stride - reaches exactly the elements of each block of a
    (possibly strided) block view."""
    x = torch.as_tensor(rng.normal(size=(v, r)))
    blocks = partition.block_decompose(x, rows, cols)
    offsets, row_stride = coded_fused._block_offsets(blocks)
    assert len(offsets) == rows * cols
    base = blocks.storage_offset()
    flat = blocks.untyped_storage()
    flat = torch.tensor([], dtype=blocks.dtype).set_(flat)
    bv, br = blocks.shape[-2:]
    vv, rr = np.meshgrid(np.arange(bv), np.arange(br), indexing="ij")
    for i, block in enumerate(blocks.reshape(-1, bv, br)):
        got = flat[base + offsets[i] + row_stride * vv + rr]
        np.testing.assert_array_equal(_np(got), _np(block))


_BASE = 0x7F3A_0000_0000  # a 256-byte aligned device address


@pytest.mark.parametrize("itemsize,operands,width", [
    # the main path: 2x2 blocks of an 8000^2 float64 matrix, both operands
    (8, [(_BASE, (0, 4000, 32_000_000, 32_004_000), 8000)] * 2, 16),
    (8, [(_BASE, (0,), 4000), (_BASE + 256, (0,), 4000)], 16),    # matmul_t A, B
    (8, [(_BASE, (0,), 4000), (_BASE, (0,), 4001)], 8),           # odd row stride
    (8, [(_BASE + 8, (0,), 4000), (_BASE, (0,), 4000)], 8),       # pointer off 16 B
    (8, [(_BASE, (0, 2001), 4002), (_BASE, (0,), 4000)], 8),      # odd block offset
    (4, [(_BASE, (0, 4, 8), 12)] * 2, 16),                        # float32, 48 B rows
    (4, [(_BASE, (0,), 6), (_BASE, (0,), 8)], 4),                 # float32, 24 B rows
    (4, [(_BASE, (0, 2), 8), (_BASE, (0,), 8)], 4),               # float32, offset 8 B
])
def test_copy_bytes_picks_16_byte_copies_only_when_aligned(itemsize, operands, width):
    """The kernels copy 16 bytes at a time only where every data pointer,
    block offset and row stride is a 16-byte multiple; else one element."""
    assert coded_fused.copy_bytes(itemsize, *operands) == width


def test_copy_bytes_on_block_views(rng):
    """The rule on the offsets and strides of real block views: a float64
    width of 12 splits into 16-byte aligned blocks, 14 does not."""
    for cols, width in ((12, 16), (14, 8)):
        x = torch.as_tensor(rng.normal(size=(8, cols)))
        blocks = partition.block_decompose(x, 2, 2)
        offsets, row_stride = coded_fused._block_offsets(blocks)
        got = coded_fused.copy_bytes(8, (_BASE, offsets, row_stride))
        assert got == width


_F64, _F32 = torch.float64, torch.float32


@pytest.mark.parametrize("dtype,width,P,Q,r,t,cluster", [
    (_F64, 16, 4, 4, 4000, 4000, True),       # the benchmark's product
    (_F64, 16, 3, 4, 300, 520, True),         # odd tile counts, P != Q
    (_F64, 16, 1, 1, 129, 129, True),         # two tiles a side, the least
    (_F32, 16, 4, 4, 4000, 4000, False),      # float32: CUDA-core FMAs
    (torch.bfloat16, 16, 4, 4, 4000, 4000, False),   # the TMA form
    (torch.float16, 16, 4, 4, 4000, 4000, False),
    (_F64, 8, 4, 4, 4000, 4000, False),       # one-element copies
    (_F64, 16, 5, 4, 4000, 4000, False),      # groups of raw blocks
    (_F64, 16, 4, 65, 4000, 4000, False),     # offsets through device memory
    (_F64, 16, 4, 4, 128, 4000, False),       # one tile along r
    (_F64, 16, 4, 4, 4000, 128, False),       # one tile along t
])
def test_cluster_form_rule(dtype, width, P, Q, r, t, cluster):
    """Kernel 1 runs its float64 cluster form only where the call shows
    float64, 16-byte copies, at most 4 raw blocks a side and two output
    tiles or more along both r and t."""
    assert coded_fused.clustered(dtype, width, P, Q, r, t) is cluster


def test_cluster_form_at_the_benchmarks_shape():
    """The benchmark's operands (2 x 2 block views of 8000^2 float64
    matrices, as the facade cuts them) give 16-byte copies and the cluster
    form; the same views in float32 keep the tile form."""
    for dtype, cluster in ((_F64, True), (_F32, False)):
        x = torch.empty((8000, 8000), dtype=dtype, device="meta")
        blocks = partition.block_decompose(x, 2, 2)
        offsets, row_stride = coded_fused._block_offsets(blocks)
        width = coded_fused.copy_bytes(x.element_size(), (_BASE, offsets, row_stride))
        P, v, r = math.prod(blocks.shape[:2]), *blocks.shape[2:]
        assert (P, v, r, width) == (4, 4000, 4000, 16)
        assert coded_fused.clustered(dtype, width, P, P, r, r) is cluster


def test_launch_counts_carry_the_cluster_form():
    """``launch_counts`` lists the cluster form's launches beside every
    wrapper's, the reset zeroes them, and the plain versions raise none."""
    counts = ops.launch_counts()
    assert counts[ops.CLUSTER_LAUNCHES] == 0 and ops.CLUSTER_LAUNCHES == (
        "fused_worker.cluster_launches")
    assert set(counts) == {"fused_worker", "decode", "decode_partial", "encode",
                           "matmul_t", "wkv_scan", "mamba_scan", ops.CLUSTER_LAUNCHES}
    ops.fused_worker.cluster_launches = 3
    assert ops.launch_counts()[ops.CLUSTER_LAUNCHES] == 3
    ops.reset_launch_counts()
    x = torch.ones(4, 300, 520, dtype=torch.float64)
    ops.fused_worker(torch.ones(2, 4, dtype=torch.float64),
                     torch.ones(2, 4, dtype=torch.float64), x, x)
    assert not any(ops.launch_counts().values())


def test_fused_worker_on_block_views_matches_stacked(rng):
    """Leading block dims flatten row-major, as the reference's reshape."""
    A = torch.as_tensor(rng.normal(size=(16, 12)))
    ca = torch.as_tensor(rng.normal(size=(3, 4)))
    view = partition.block_decompose(A, 2, 2)
    stacked = view.reshape(4, 8, 6).contiguous()
    np.testing.assert_array_equal(_np(ops.fused_worker(ca, ca, view, view)),
                                  _np(ops.fused_worker(ca, ca, stacked, stacked)))


def _integer_products(rng, kind, p, m, n, pp, erased):
    """(W, Y) from a real plan's panel and worker products of integer
    matrices, so X = W @ Y lies inside the plan's bounds."""
    v, r, t = 8 * p, 12, 10
    plan = japi.make_plan(kind, p, m, n, K=9, L=v * 9 + 1, p_prime=pp,
                          points="chebyshev")
    A = jnp.asarray(rng.integers(-3, 4, size=(v, r)), jnp.float64)
    B = jnp.asarray(rng.integers(-3, 4, size=(v, t)), jnp.float64)
    Y = japi.fused_worker_products(plan, jpart.block_decompose(A, p, m),
                                   jpart.block_decompose(B, p, n))
    mask = np.ones(plan.K)
    mask[erased] = 0
    W = plan.make_panel_cache().get(mask).W
    Y = np.asarray(Y).reshape(plan.K, -1) * mask[:, None]
    return plan, W, Y


@pytest.mark.parametrize("kind,p,m,n,pp,extract", [
    ("bec", 2, 2, 2, 1, True),
    ("bec", 2, 2, 2, 1, False),
    ("tradeoff", 4, 2, 1, 2, True),
    ("polycode", 2, 2, 1, 1, False),
])
def test_decode_matches_jax(rng, kind, p, m, n, pp, extract):
    plan, W, Y = _integer_products(rng, kind, p, m, n, pp, erased=[0, 4])
    got = _np(ops.decode(torch.as_tensor(W), torch.as_tensor(Y), plan.s,
                         extract=extract))
    exp = np.asarray(jops.decode(jnp.asarray(W), jnp.asarray(Y), plan.s,
                                 extract=extract))
    np.testing.assert_array_equal(got, exp)
    assert ops.launch_counts()["decode"] == 0


def test_decode_ref_handles_halves_and_signs():
    """Round half to even, then mod s and recentre, like jnp."""
    s = 16.0
    X = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 8.0, 8.5, -8.0, -8.5, 23.5, -23.5]])
    W = np.ones((1, 1))
    for extract in (True, False):
        got = _np(ref.decode_ref(torch.as_tensor(W), torch.as_tensor(X), s, extract))
        exp = np.asarray(jops.decode(jnp.asarray(W), jnp.asarray(X), s,
                                     extract=extract))
        np.testing.assert_array_equal(got, exp)


def test_decode_complex_routes_to_plain(rng):
    W = rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))
    Y = rng.normal(size=(3, 7)) + 1j * rng.normal(size=(3, 7))
    got = _np(ops.decode(torch.as_tensor(W), torch.as_tensor(Y), 64.0))
    exp = np.asarray(jref.decode_ref(jnp.asarray(W), jnp.asarray(Y), 64.0))
    np.testing.assert_array_equal(got, exp)
    got = _np(ops.decode(torch.as_tensor(W), torch.as_tensor(Y), 64.0, extract=False))
    np.testing.assert_array_equal(got, np.round((W @ Y).real))


def test_plain_versions_match_jax_ref(rng):
    coeff = rng.normal(size=(4, 3))
    blocks = rng.normal(size=(3, 50))
    np.testing.assert_allclose(
        _np(ref.encode_ref(torch.as_tensor(coeff), torch.as_tensor(blocks))),
        np.asarray(jref.encode_ref(jnp.asarray(coeff), jnp.asarray(blocks))),
        rtol=1e-12)
    A = rng.normal(size=(20, 6))
    B = rng.normal(size=(20, 5))
    np.testing.assert_allclose(
        _np(ref.matmul_t_ref(torch.as_tensor(A), torch.as_tensor(B))),
        np.asarray(jref.matmul_t_ref(jnp.asarray(A), jnp.asarray(B))), rtol=1e-12)
    half = ref.matmul_t_ref(torch.as_tensor(A, dtype=torch.bfloat16),
                            torch.as_tensor(B, dtype=torch.bfloat16))
    assert half.dtype == torch.bfloat16


def test_fused_worker_products_match_jax(rng):
    p, m, n = 2, 2, 2
    jplan = japi.make_plan("bec", p, m, n, K=6, L=100, points="equispaced")
    plan = api.make_plan("bec", p, m, n, K=6, L=100, points="equispaced")
    A = rng.normal(size=(10, 9))
    B = rng.normal(size=(10, 7))
    got = _np(api.fused_worker_products(
        plan, partition.block_decompose(torch.as_tensor(A), p, m),
        partition.block_decompose(torch.as_tensor(B), p, n)))
    exp = np.asarray(japi.fused_worker_products(
        jplan, jpart.block_decompose(jnp.asarray(A), p, m),
        jpart.block_decompose(jnp.asarray(B), p, n)))
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-10 * np.abs(exp).max())


def test_wrappers_reject_mixed_devices():
    x = torch.ones(2, 2)
    meta = torch.ones(2, 2, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU"):
        ops.decode(x, meta, 4.0)


@pytest.mark.parametrize("K,P,E", [(10, 4, 4096), (3, 5, 1000), (1, 1, 7), (17, 20, 33)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode_matches_jax(rng, K, P, E, dtype):
    coeff = rng.normal(size=(K, P)).astype(dtype)
    blocks = rng.normal(size=(P, E)).astype(dtype)
    got = _np(ops.encode(torch.as_tensor(coeff), torch.as_tensor(blocks)))
    exp = np.asarray(jops.encode(jnp.asarray(coeff), jnp.asarray(blocks)))
    assert got.dtype == exp.dtype == dtype and got.shape == (K, E)
    np.testing.assert_allclose(got, exp, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(exp).max())
    ints = [rng.integers(-9, 10, size=x.shape).astype(dtype) for x in (coeff, blocks)]
    np.testing.assert_array_equal(
        _np(ops.encode(*map(torch.as_tensor, ints))),
        np.asarray(jops.encode(*map(jnp.asarray, ints))))
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("v,r,rows,cols", [(16, 12, 2, 2), (9, 7, 2, 2), (12, 8, 4, 2)])
def test_encode_on_block_views_matches_stacked(rng, v, r, rows, cols):
    """A (*grid, rows, cols) block view encodes to the (K, rows, cols) stack
    the reference package's (P, E) form gives."""
    x = torch.as_tensor(rng.normal(size=(v, r)))
    coeff = torch.as_tensor(rng.normal(size=(5, rows * cols)))
    view = partition.block_decompose(x, rows, cols)
    got = ops.encode(coeff, view)
    bv, br = view.shape[-2:]
    assert got.shape == (5, bv, br)
    stacked = view.reshape(rows * cols, -1)
    np.testing.assert_array_equal(_np(got).reshape(5, -1),
                                  _np(ops.encode(coeff, stacked)))
    exp = np.asarray(jops.encode(jnp.asarray(coeff.numpy()), jnp.asarray(stacked.numpy())))
    np.testing.assert_allclose(_np(got).reshape(5, -1), exp, rtol=1e-12, atol=1e-12)


def test_encode_complex_routes_to_plain(rng):
    coeff = rng.normal(size=(3, 2)) + 1j * rng.normal(size=(3, 2))
    blocks = rng.normal(size=(2, 2, 3, 5))
    got = _np(ops.encode(torch.as_tensor(coeff.repeat(2, axis=1)), torch.as_tensor(blocks)))
    exp = np.asarray(jops.encode(jnp.asarray(coeff.repeat(2, axis=1)),
                                 jnp.asarray(blocks.reshape(4, 15))))
    assert got.shape == (3, 3, 5)
    np.testing.assert_allclose(got.reshape(3, 15), exp, rtol=1e-12)


@pytest.mark.parametrize("v,r,t", [(256, 128, 128), (300, 200, 150), (129, 257, 65),
                                   (1, 1, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmul_t_matches_jax(rng, v, r, t, dtype):
    A = rng.normal(size=(v, r)).astype(dtype)
    B = rng.normal(size=(v, t)).astype(dtype)
    got = _np(ops.matmul_t(torch.as_tensor(A), torch.as_tensor(B)))
    exp = np.asarray(jops.matmul_t(jnp.asarray(A), jnp.asarray(B)))
    assert got.dtype == exp.dtype == dtype and got.shape == (r, t)
    np.testing.assert_allclose(got, exp, rtol=RTOL[dtype] * 10,
                               atol=RTOL[dtype] * 10 * np.abs(exp).max())
    ints = [rng.integers(-9, 10, size=x.shape).astype(dtype) for x in (A, B)]
    np.testing.assert_array_equal(
        _np(ops.matmul_t(*map(torch.as_tensor, ints))),
        np.asarray(jops.matmul_t(*map(jnp.asarray, ints))))
    assert not any(ops.launch_counts().values())


def test_matmul_t_writes_out_and_routes_complex(rng):
    A = torch.as_tensor(rng.normal(size=(20, 6)))
    B = torch.as_tensor(rng.normal(size=(20, 5)))
    Y = torch.zeros(3, 6, 5, dtype=torch.float64)
    slot = Y[2]
    assert ops.matmul_t(A, B, out=slot) is slot
    np.testing.assert_array_equal(_np(Y[2]), _np(ops.matmul_t(A, B)))
    assert not Y[:2].any()
    Ac = rng.normal(size=(8, 3)) + 1j * rng.normal(size=(8, 3))
    Bc = rng.normal(size=(8, 4))
    np.testing.assert_allclose(
        _np(ops.matmul_t(torch.as_tensor(Ac), torch.as_tensor(Bc))),
        np.asarray(jops.matmul_t(jnp.asarray(Ac), jnp.asarray(Bc))), rtol=1e-12)


@pytest.mark.parametrize("kind,p,m,n,pp,extract", [
    ("bec", 2, 2, 2, 1, True),
    ("bec", 2, 2, 2, 1, False),
    ("tradeoff", 4, 2, 1, 2, True),
    ("polycode", 2, 2, 1, 1, False),
])
def test_decode_partial_matches_jax(rng, kind, p, m, n, pp, extract):
    """The reference package's (Q, K, Ec) form: chunk q of real worker
    products (integer operands) through chunk q's panel, exactly."""
    plan, W, Y = _integer_products(rng, kind, p, m, n, pp, erased=[])
    Q = 3
    counts = np.array([Q, Q - 1, Q - 1, 0] + [Q] * (plan.K - 4))
    from repro.runtime.partial import chunk_masks_for
    cmasks = chunk_masks_for(counts, Q)
    W_stack = plan.make_panel_cache().get_partial(cmasks)
    Ec = Y.shape[1] // Q
    Ys = np.stack([Y[:, q * Ec:(q + 1) * Ec] * cmasks[q][:, None] for q in range(Q)])
    got = _np(ops.decode_partial(torch.as_tensor(W_stack), torch.as_tensor(Ys), plan.s,
                                 extract=extract))
    exp = np.asarray(jops.decode_partial(jnp.asarray(W_stack), jnp.asarray(Ys), plan.s,
                                         extract=extract))
    np.testing.assert_array_equal(got, exp)
    per_chunk = np.stack([_np(ops.decode(torch.as_tensor(W_stack[q]), torch.as_tensor(Ys[q]),
                                         plan.s, extract=extract)) for q in range(Q)])
    np.testing.assert_array_equal(got, per_chunk)
    assert not any(ops.launch_counts().values())


def test_decode_partial_bounds_form_matches_per_chunk(rng):
    """Y (K, E) with chunks of unequal width: each chunk's columns decode
    with its own panel, in place in the (mn, E) result."""
    Q, mn, K, E = 3, 4, 6, 29
    bounds = [0, 10, 20, 29]
    W = torch.as_tensor(rng.integers(-3, 4, size=(Q, mn, K)), dtype=torch.float64)
    Y = torch.as_tensor(rng.integers(-5, 6, size=(K, E)), dtype=torch.float64)
    got = ops.decode_partial(W, Y, 7.0, bounds=bounds)
    assert got.shape == (mn, E)
    for q in range(Q):
        cols = slice(bounds[q], bounds[q + 1])
        np.testing.assert_array_equal(_np(got[:, cols]),
                                      _np(ops.decode(W[q], Y[:, cols], 7.0)))


_MAIN = ((0, 4_000_000, 8_000_000, 12_000_000), (16_000_000,), (4_000_000,) * 4)


@pytest.mark.parametrize("itemsize,addresses,offsets,strides,widths,bulk", [
    # the main path: Q=4 chunks of 4e6 float64 columns of Y (10, 16e6)
    (8, (_BASE, _BASE + 2**20), *_MAIN, True),
    (8, (_BASE, _BASE), (0, 0, 16), (1040,), (0, 16, 1024), True),   # a width of 0
    (4, (_BASE, _BASE), (0, 4, 8), (12,), (4, 4, 4), True),          # float32
    (8, (_BASE + 8, _BASE), *_MAIN, False),                          # Y 8 B off
    (8, (_BASE, _BASE + 8), *_MAIN, False),                          # output 8 B off
    (8, (_BASE, _BASE), (0, 1025), (4096,), (1025, 3071), False),    # odd offset
    (8, (_BASE, _BASE), (0, 1024), (4097,), (1024, 1024), False),    # odd row stride
    (8, (_BASE, _BASE), (0, 1024), (4096,), (1024, 1023), False),    # odd width
    (4, (_BASE, _BASE), (0, 2), (8,), (2, 6), False),                # float32, 8 B off
    (4, (_BASE, _BASE), (0, 4), (8, 6), (4, 4), False),              # output rows 24 B
])
def test_bulk_copies_only_when_aligned(itemsize, addresses, offsets, strides, widths, bulk):
    """The per-chunk decode kernel takes its bulk-copy form only where every
    address, chunk offset, row stride and chunk width is 16 bytes wide;
    else its one-element form."""
    assert coded_decode.bulk_copies(itemsize, addresses, offsets, strides, widths) is bulk


def test_decode_partial_complex_routes_to_plain(rng):
    Q, mn, K, E = 2, 4, 3, 6
    W = rng.integers(-2, 3, size=(Q, mn, K)) + 1j * rng.integers(-2, 3, size=(Q, mn, K))
    Y = rng.integers(-3, 4, size=(Q, K, E)).astype(np.float64)
    got = _np(ops.decode_partial(torch.as_tensor(W), torch.as_tensor(Y), 5.0))
    exp = np.asarray(jops.decode_partial(jnp.asarray(W), jnp.asarray(Y), 5.0))
    np.testing.assert_array_equal(got, exp)


def test_new_kernel_launchers_validate_before_building():
    """The encode, block-matmul and per-chunk decode launchers refuse CPU
    tensors and unsupported dtypes before touching nvcc.  bf16/f16 are
    kernel dtypes (tests/test_torch_half.py holds them against JAX), so a
    half-precision CPU tensor is refused as a CPU tensor."""
    x = torch.ones(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        coded_encode.encode_cuda(torch.ones(3, 2), x)
    with pytest.raises(ValueError, match="CUDA"):
        coded_encode.encode_cuda(torch.ones(3, 2).half(), x.half())
    with pytest.raises(NotImplementedError, match="bfloat16 or float16, not torch.int32"):
        coded_encode.encode_cuda(torch.ones(3, 2, dtype=torch.int32), x.int())
    with pytest.raises(ValueError, match="CUDA"):
        block_matmul.matmul_t_cuda(x[0], x[1])
    with pytest.raises(ValueError, match="CUDA"):
        block_matmul.matmul_t_cuda(x[0].bfloat16(), x[1].bfloat16())
    with pytest.raises(NotImplementedError, match="bfloat16 or float16, not torch.complex64"):
        block_matmul.matmul_t_cuda(x[0].to(torch.complex64), x[1].to(torch.complex64))
    with pytest.raises(ValueError, match="CUDA"):
        coded_decode.decode_partial_cuda(torch.ones(2, 4, 3), x.transpose(1, 2)[:, :3], 8.0)
    assert not _build._LIBS


def test_kernel_launchers_validate_before_building():
    """The CUDA launchers check their operands before touching nvcc, so a
    CPU tensor or an unsupported dtype is refused here too."""
    x = torch.ones(2, 3, 4)
    c = torch.ones(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        coded_fused.fused_worker_cuda(c, c, x[:2], x[:2])
    with pytest.raises(ValueError, match="CUDA"):
        coded_fused.fused_worker_cuda(c.bfloat16(), c.bfloat16(),
                                      x[:2].bfloat16(), x[:2].bfloat16())
    with pytest.raises(NotImplementedError, match="bfloat16 or float16, not torch.int32"):
        coded_fused.fused_worker_cuda(c.int(), c.int(), x[:2].int(), x[:2].int())
    with pytest.raises(ValueError, match="CUDA"):
        coded_decode.decode_cuda(torch.ones(4, 3), torch.ones(3, 5), 8.0)


def test_scan_launchers_validate_before_building():
    """The WKV and selective-scan launchers refuse CPU tensors and other
    dtypes before touching nvcc (shapes are checked on the card:
    tests/test_torch_gpu.py)."""
    z = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_scan.wkv_scan_cuda(z, z, z, z, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="float32"):
        wkv_scan.wkv_scan_cuda(z.double(), z, z, z, torch.zeros(2, 8))
    x, bm = torch.zeros(1, 8, 4), torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan.mamba_scan_cuda(x, x, bm, bm, torch.zeros(4, 16), torch.zeros(4))
    with pytest.raises(ValueError, match="float32"):
        mamba_scan.mamba_scan_cuda(x.half(), x, bm, bm, torch.zeros(4, 16), torch.zeros(4))
    assert not _build._LIBS
    assert {"wkv_scan", "mamba_scan"} <= set(_build.SOURCES)


@pytest.mark.parametrize("dv,addresses,elems", [
    (64, (_BASE, _BASE + 256, _BASE + 512, _BASE + 768), 4),
    (40, (_BASE,) * 4, 4),
    (37, (_BASE,) * 4, 1),        # v rows off 16 bytes
    (64, (_BASE, _BASE + 4, _BASE, _BASE), 1),   # one input 4 bytes off
    (64, (_BASE + 8,) * 4, 1),
])
def test_wkv_copy_elems_picks_16_byte_copies_only_when_aligned(dv, addresses, elems):
    assert wkv_scan.copy_elems(dv, *addresses) == elems


def test_build_is_lazy_and_keyed_by_source():
    """Nothing is loaded on the CPU path; each library's name hashes its
    source and flags, inside the repository's build directory."""
    assert not _build._LIBS
    paths = [_build._library_path(name) for name in _build.SOURCES]
    assert len(set(paths)) == len(paths)
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert paths == [_build._library_path(name) for name in _build.SOURCES]


# ---------------------------------------------------------------------------
# the WKV and selective-scan kernels' plain versions against Pallas


@pytest.mark.parametrize("B,S,H,dk,chunk", [
    (2, 64, 3, 8, 16), (1, 48, 2, 16, 8),
    (1, 40, 2, 8, 16),            # chunk 16 halved to 8: 5 chunk states
])
def test_wkv_scan_matches_pallas(rng, B, S, H, dk, chunk):
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, dk)))).astype(np.float32)
    k, v, r = (rng.normal(size=(B, S, H, dk)).astype(np.float32) for _ in range(3))
    u = rng.normal(size=(H, dk)).astype(np.float32)
    exp = wkv_scan_pallas(*map(jnp.asarray, (w, k, v, r, u)), chunk=chunk,
                          interpret=True)
    got = ops.wkv_scan(*map(torch.as_tensor, (w, k, v, r, u)), chunk=chunk)
    for o, e in zip(got, exp):
        assert o.shape == e.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(e), rtol=1e-4, atol=1e-4)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("B,S,d,s,chunk,d_blk", [
    (2, 64, 32, 8, 16, 16), (1, 128, 16, 4, 32, 16), (3, 48, 24, 16, 16, 8),
    (1, 40, 24, 8, 16, 16),       # chunk 16 halved to 8, d_blk 16 to 8
])
def test_mamba_scan_matches_pallas(rng, B, S, d, s, chunk, d_blk):
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(B, S, d))), np.float32)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, s)).astype(np.float32) for _ in range(2))
    A_log = rng.uniform(0.1, 1.0, size=(d, s)).astype(np.float32)
    D = rng.normal(size=(d,)).astype(np.float32)
    exp = mamba_scan_pallas(*map(jnp.asarray, (dt, x, Bm, Cm, A_log, D)),
                            chunk=chunk, d_blk=d_blk, interpret=True)
    got = ops.mamba_scan(*map(torch.as_tensor, (dt, x, Bm, Cm, A_log, D)), chunk=chunk)
    for o, e in zip(got, exp):
        assert o.shape == e.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(e), rtol=1e-4, atol=1e-4)
    assert not any(ops.launch_counts().values())
