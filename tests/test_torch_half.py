"""The coded product wrappers at half precision (bf16 and f16), on the CPU,
against the JAX package's ``repro.kernels.ops`` (Pallas in interpret mode,
as ``tests/test_kernels.py`` runs it).

The port's contract (``kernels/ref.py``, the CUDA kernels on the card):
every sum in float32, each result rounded once to its output dtype; the
fused product's coded operands rounded once to the input dtype.  The TPU
kernels round elsewhere (the fused encode sums in the input dtype), so the
two packages agree to the tolerances of ``tests/test_kernels.py``: 2e-2 of
the largest value for encode and the fused product, 2e-2 * sqrt(v)
element by element for ``matmul_t``.  Inputs are float32 values from a
seeded numpy stream, rounded to the half dtype the same way in both
packages (round to nearest even).
"""
import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.partition import block_decompose  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 2e-2
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


@pytest.fixture(autouse=True)
def _launch_counts():
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values())  # the CPU runs no kernel
    ops.reset_launch_counts()


def _pair(rng, shape, name):
    """The same half-precision values as a torch tensor and a JAX array."""
    x = rng.normal(size=shape).astype(np.float32)
    tdt, jdt = DTYPES[name]
    return torch.as_tensor(x).to(tdt), jnp.asarray(x).astype(jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_to_max(got, exp):
    g, e = _f32(got), _f32(exp)
    assert g.shape == e.shape
    assert np.max(np.abs(g - e)) / (np.max(np.abs(e)) + 1e-9) < TOL


@pytest.mark.parametrize("K,P,E", [(4, 4, 256), (10, 8, 2048), (16, 16, 4096),
                                   (3, 6, 1000), (1, 1, 128)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_encode_matches_jax(rng, K, P, E, name):
    c, jc = _pair(rng, (K, P), name)
    x, jx = _pair(rng, (P, E), name)
    got = ops.encode(c, x)
    exp = jops.encode(jc, jx)
    assert got.dtype == DTYPES[name][0] and exp.dtype == DTYPES[name][1]
    _close_to_max(got, exp)


@pytest.mark.parametrize("K,P,E", [
    (10, 4, 4096),    # the flat form, E % 8 == 0 (the kernel's 16-byte form)
    (10, 4, 4100),    # E % 8 != 0 (the one-element form)
    (6, 20, 1024),    # P = 20: past one group of 8 raw loads
    (4, 20, 1001),
    (17, 4, 512),     # K = 17
    (17, 9, 520),
])
@pytest.mark.parametrize("name", list(DTYPES))
def test_encode_forms_match_jax(rng, K, P, E, name):
    """The shapes on either side of the encode kernel's form and group
    edges, through the plain version here."""
    c, jc = _pair(rng, (K, P), name)
    x, jx = _pair(rng, (P, E), name)
    got = ops.encode(c, x)
    assert got.dtype == DTYPES[name][0] and got.shape == (K, E)
    _close_to_max(got, jops.encode(jc, jx))


@pytest.mark.parametrize("grid,v,r", [((2, 2), 64, 96), ((2, 1), 40, 24),
                                      ((4, 5), 36, 45)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_encode_of_strided_block_views_matches_jax(rng, grid, v, r, name):
    """ops.encode reads block_decompose's strided views in place; the JAX
    ops.encode gets the same blocks stacked as (P, E)."""
    P = grid[0] * grid[1]
    c, jc = _pair(rng, (5, P), name)
    A, _ = _pair(rng, (grid[0] * v, grid[1] * r), name)
    view = block_decompose(A, *grid)
    got = ops.encode(c, view)
    assert got.shape == (5, v, r)
    stack = view.reshape(P, v * r).float().numpy()
    exp = jops.encode(jc, jnp.asarray(stack).astype(DTYPES[name][1]))
    _close_to_max(got.reshape(5, -1), exp)


@pytest.mark.parametrize("v,r,t", [(128, 128, 128), (512, 256, 384),
                                   (300, 200, 150), (64, 640, 64),
                                   (1024, 128, 128)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_matmul_t_matches_jax(rng, v, r, t, name):
    A, jA = _pair(rng, (v, r), name)
    B, jB = _pair(rng, (v, t), name)
    got = ops.matmul_t(A, B)
    exp = jops.matmul_t(jA, jB)
    assert got.dtype == DTYPES[name][0] and exp.dtype == DTYPES[name][1]
    tol = TOL * v ** 0.5
    np.testing.assert_allclose(_f32(got), _f32(exp), rtol=tol, atol=tol)


@pytest.mark.parametrize("K,P,Q,v,r,t", [
    (4, 4, 4, 256, 128, 128),
    (6, 8, 2, 300, 200, 150),     # ragged, non-tile-multiple
    (3, 1, 1, 64, 40, 24),
    (1, 5, 3, 129, 257, 65),      # off-by-one everywhere
])
@pytest.mark.parametrize("name", list(DTYPES))
def test_fused_worker_matches_jax(rng, K, P, Q, v, r, t, name):
    ca, jca = _pair(rng, (K, P), name)
    cb, jcb = _pair(rng, (K, Q), name)
    a, ja = _pair(rng, (P, v, r), name)
    b, jb = _pair(rng, (Q, v, t), name)
    got = ops.fused_worker(ca, cb, a, b)
    exp = jops.fused_worker(jca, jcb, ja, jb)
    assert got.dtype == DTYPES[name][0] and got.shape == (K, r, t)
    _close_to_max(got, exp)


@pytest.mark.parametrize("name", list(DTYPES))
def test_float32_out_is_the_float32_accumulator(rng, name):
    """``out_dtype=float32`` returns the float32 sums, as the reference
    casts its f32 accumulator, not the half result widened."""
    a, ja = _pair(rng, (3, 96, 40), name)
    b, jb = _pair(rng, (2, 96, 24), name)
    ca, jca = _pair(rng, (5, 3), name)
    cb, jcb = _pair(rng, (5, 2), name)
    got = ops.fused_worker(ca, cb, a, b, out_dtype=torch.float32)
    exp = jops.fused_worker(jca, jcb, ja, jb, out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    _close_to_max(got, exp)
    wide = ops.matmul_t(a[0], b[0], out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    np.testing.assert_allclose(_f32(wide), _f32(jops.matmul_t(ja[0], jb[0], out_dtype=jnp.float32)),
                               rtol=1e-5, atol=1e-5)
    assert not torch.equal(wide, ops.matmul_t(a[0], b[0]).float())
