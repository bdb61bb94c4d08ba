"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips, with a reason, where no CUDA
device is present.  Run them on a machine with one card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import make_plan
from repro_torch.core.partition import block_decompose
from repro_torch.kernels import ops, ref
from repro_torch.runtime import CodedMatmul

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}  # sums taken in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    yield torch.device("cuda")
    ops.reset_launch_counts()


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=torch.float64).to("cuda", dtype)


@pytest.mark.parametrize("K,P,Q,v,r,t", [
    (4, 4, 4, 256, 128, 128),
    (6, 8, 2, 300, 200, 150),
    (3, 1, 1, 64, 40, 24),
    (1, 5, 3, 129, 257, 65),
    (2, 3, 2, 0, 9, 7),           # empty contraction: zeros
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_kernel_matches_plain(cuda, K, P, Q, v, r, t, dtype):
    gen = torch.Generator().manual_seed(0)
    ca, cb = _rand(gen, (K, P), dtype), _rand(gen, (K, Q), dtype)
    a, b = _rand(gen, (P, v, r), dtype), _rand(gen, (Q, v, t), dtype)
    out = ops.fused_worker(ca, cb, a, b)
    exp = ref.fused_worker_ref(ca, cb, a, b)
    torch.cuda.synchronize()
    assert out.shape == (K, r, t) and out.dtype == dtype
    scale = float(exp.abs().max()) + 1e-9
    assert float((out - exp).abs().max()) / scale < TOL[dtype]
    assert ops.launch_counts()["fused_worker"] == 1


def test_fused_kernel_on_strided_block_views(cuda):
    gen = torch.Generator().manual_seed(1)
    A = _rand(gen, (130, 250), torch.float64)
    B = _rand(gen, (130, 66), torch.float64)
    ca, cb = _rand(gen, (5, 4), torch.float64), _rand(gen, (5, 2), torch.float64)
    a4, b4 = block_decompose(A, 2, 2), block_decompose(B, 2, 1)
    assert not a4.is_contiguous()
    out = ops.fused_worker(ca, cb, a4, b4)
    exp = ops.fused_worker(ca, cb, a4.reshape(4, 65, 125).contiguous(),
                           b4.reshape(2, 65, 66).contiguous())
    torch.testing.assert_close(out, exp, rtol=0, atol=0)


def test_fused_kernel_refuses_half_precision(cuda):
    x = torch.ones(2, 8, 8, device=cuda, dtype=torch.bfloat16)
    c = torch.ones(1, 2, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float64 or float32"):
        ops.fused_worker(c, c, x, x)


@pytest.mark.parametrize("extract", [True, False])
def test_decode_kernel_on_worker_products(cuda, extract):
    """Exact against the plain version on worker products of integer
    matrices, whose X lies inside the plan's bounds."""
    gen = torch.Generator().manual_seed(2)
    v = 40
    for kind, p, m, n, pp in (("bec", 2, 2, 2, 1), ("tradeoff", 4, 2, 1, 2)):
        plan = make_plan(kind, p, m, n, K=8, L=v * 9 + 1, p_prime=pp,
                         points="chebyshev")
        A = torch.randint(-3, 4, (v, 37), generator=gen).to(cuda, torch.float64)
        B = torch.randint(-3, 4, (v, 29), generator=gen).to(cuda, torch.float64)
        Y = ops.fused_worker(
            torch.as_tensor(plan.coeff_a.reshape(plan.K, -1), device=cuda),
            torch.as_tensor(plan.coeff_b.reshape(plan.K, -1), device=cuda),
            block_decompose(A, p, m), block_decompose(B, p, n)).reshape(plan.K, -1)
        mask = np.ones(plan.K)
        mask[[1, 2]] = 0
        W = torch.as_tensor(plan.make_panel_cache().get(mask).W, device=cuda)
        Ym = Y * torch.as_tensor(mask, device=cuda)[:, None]
        out = ops.decode(W, Ym, plan.s, extract=extract)
        torch.testing.assert_close(out, ref.decode_ref(W, Ym, plan.s, extract),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("extract", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decode_kernel_wide_panel(cuda, extract, dtype):
    """Integer W and Y make X exact in either dtype; mn = 20 rows take the
    kernel past its 16 register rows, and E is ragged."""
    gen = torch.Generator().manual_seed(4)
    W = torch.randint(-2, 3, (20, 30), generator=gen).to(cuda, dtype)
    Y = torch.randint(-40, 41, (30, 4099), generator=gen).to(cuda, dtype)
    out = ops.decode(W, Y, 64.0, extract=extract)
    torch.testing.assert_close(out, ref.decode_ref(W, Y, 64.0, extract),
                               rtol=0, atol=0)


def test_decode_kernel_rounds_halves_to_even(cuda):
    X = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 8.0, 8.5, -8.0, -8.5, 23.5, -23.5]],
                     dtype=torch.float64, device=cuda)
    W = torch.ones(1, 1, dtype=torch.float64, device=cuda)
    for extract in (True, False):
        torch.testing.assert_close(ops.decode(W, X, 16.0, extract=extract),
                                   ref.decode_ref(W, X, 16.0, extract),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kind,p,m,n,pp", [("bec", 2, 2, 2, 1),
                                           ("tradeoff", 4, 2, 1, 2),
                                           ("polycode", 2, 2, 1, 1)])
def test_coded_matmul_on_the_card_is_exact(cuda, kind, p, m, n, pp):
    gen = torch.Generator().manual_seed(3)
    v, r, t = 8 * p + 3, 45, 33
    A = torch.randint(-3, 4, (v, r), generator=gen).to(torch.float64)
    B = torch.randint(-3, 4, (v, t), generator=gen).to(torch.float64)
    plan = make_plan(kind, p, m, n, K=9, L=v * 9 + 1, p_prime=pp,
                     points="chebyshev")
    cm = CodedMatmul(plan)
    assert cm.device.type == "cuda"
    for i, erased in enumerate(([], [0], [3, 8])):
        C = cm(A, B, erased=erased)
        assert C.device.type == "cuda"
        torch.testing.assert_close(C.cpu(), A.T @ B, rtol=0, atol=0)
        assert ops.launch_counts() == {"fused_worker": i + 1, "decode": i + 1}
    C_ref = cm.with_backend("reference")(A, B, erased=[3, 8])
    torch.testing.assert_close(C_ref.cpu(), A.T @ B, rtol=0, atol=0)
    assert ops.launch_counts() == {"fused_worker": 3, "decode": 3}
