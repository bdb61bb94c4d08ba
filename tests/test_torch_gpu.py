"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips, with a reason, where no CUDA
device is present.  Run them on a machine with one card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

import ast
import copy
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_plan
from repro_torch.core.partition import block_decompose
from repro_torch.kernels import coded_decode, coded_encode, coded_fused, ops, ref, wkv_scan
from repro_torch.models import decode_step, init_params, prefill, train_loss
from repro_torch.models.mamba import MambaScanFused
from repro_torch.models.rwkv6 import WkvFused
from repro_torch.models.moe import MoEConfig, _route, apply_moe, init_moe
from repro_torch.runtime import CodedMatmul

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.float64: 1e-10,   # sums taken in another order
       # FP32 sums rounded once to bf16 / f16 (tests/test_kernels.py's bound)
       torch.bfloat16: 2e-2, torch.float16: 2e-2}
HALF = [torch.bfloat16, torch.float16]


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


def _data(gen, shape, dtype, data):
    """Random normal values, or integers in [-3, 3] (every sum the kernels
    and the plain versions form is then an exact integer in float32 too)."""
    if data == "integer":
        return torch.randint(-3, 4, shape, generator=gen).to("cuda", dtype)
    return _rand(gen, shape, dtype)


def _with_row_stride(x, stride):
    """x's values in a view whose row stride is a 16-byte multiple
    ("aligned": the kernels' 16-byte copies) or an odd number of elements
    ("odd": one-element copies)."""
    width = x.shape[-1]
    if stride == "aligned":
        step = 16 // x.element_size()
        ld = -(-width // step) * step
    else:
        ld = width if width % 2 else width + 1
    buf = torch.zeros((*x.shape[:-1], ld), dtype=x.dtype, device=x.device)
    buf[..., :width] = x
    return buf[..., :width]


def _check(out, exp, data):
    """Integer inputs exactly, random ones within TOL of the largest value."""
    torch.cuda.synchronize()
    assert out.shape == exp.shape and out.dtype == exp.dtype
    if data == "integer":
        torch.testing.assert_close(out, exp, rtol=0, atol=0)
    else:
        scale = float(exp.float().abs().max()) + 1e-9
        assert float((out.float() - exp.float()).abs().max()) / scale < TOL[out.dtype]


def _encode_form(blocks):
    """The form ops.encode launches kernel 4 in for ``blocks`` (*grid, rows,
    cols), or (P, E), which it passes as (P, 1, E): 16 (16-byte loads and
    stores) or the element size (one element a thread)."""
    x = blocks.unsqueeze(1) if blocks.ndim == 2 else blocks
    offsets, row_stride = coded_fused._block_offsets(x)
    return coded_fused.encode_width(x.element_size(), x.shape[-1],
                                    (x.data_ptr(), offsets, row_stride))


@pytest.mark.parametrize("K,P,Q,v,r,t", [
    (4, 4, 4, 256, 128, 128),
    (6, 8, 2, 300, 200, 150),
    (3, 1, 1, 64, 40, 24),
    (1, 5, 3, 129, 257, 65),
    (2, 3, 2, 0, 9, 7),           # empty contraction: zeros
    (1, 4, 4, 300, 129, 257),     # K=1, as the mesh caller sends
    (7, 4, 4, 100, 257, 129),     # odd K
    (5, 1, 1, 5, 129, 4000),      # P=Q=1; v below one 8-row step
    (2, 64, 3, 21, 65, 33),       # P=64: 16 groups of raw blocks per step
    (3, 2, 64, 13, 4000, 40),     # Q=64, r=4000
])
@pytest.mark.parametrize("stride", ["aligned", "odd"])
@pytest.mark.parametrize("data", ["random", "integer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, *HALF])
def test_fused_kernel_matches_plain(cuda, K, P, Q, v, r, t, stride, data, dtype):
    """Every shape in both copy forms: for bf16/f16 the 16-byte form is the
    TMA + wgmma loop (worker pairs, K = 1 and odd K masking a warpgroup, P or
    Q = 64 on the grouped plan), the one-element form the mma.sync loop."""
    gen = torch.Generator().manual_seed(0)
    ca, cb = _data(gen, (K, P), dtype, data), _data(gen, (K, Q), dtype, data)
    a = _with_row_stride(_data(gen, (P, v, r), dtype, data), stride)
    b = _with_row_stride(_data(gen, (Q, v, t), dtype, data), stride)
    width = coded_fused.copy_bytes(a.element_size(), *(
        (x.data_ptr(), coded_fused._block_offsets(x)[0], x.stride(-2)) for x in (a, b)))
    assert width == (16 if stride == "aligned" else a.element_size())
    out = ops.fused_worker(ca, cb, a, b)
    _check(out, ref.fused_worker_ref(ca, cb, a, b), data)
    assert ops.launch_counts()["fused_worker"] == 1


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("stride", ["aligned", "odd"])
@pytest.mark.parametrize("dtype", HALF)
def test_half_fused_equals_staged_bit_for_bit(cuda, dtype, stride, m):
    """The 16-bit fused Y is the staged one (kernel 4, then kernel 5 per
    worker) bit for bit, at a shape of several tiles: coded tiles rounded
    once from the same FP32 sums, products on the same instruction in the
    same contraction order.  In the TMA form (block views of 16-byte aligned
    matrices; kernel 4's 16-byte form) and in the one-element form (odd row
    strides and odd widths, so that the staged product's coded operands take
    it too).  m = 3 gives A P = 6 raw blocks: kernel 1's grouped plan, whose
    FP32 partial sums wait in shared memory between groups of 4 blocks."""
    gen = torch.Generator().manual_seed(11)
    K, v = 5, 300
    r, t = (256, 384) if stride == "aligned" else (257, 129)
    A = _with_row_stride(_rand(gen, (m * v, 2 * r), dtype), stride)
    B = _with_row_stride(_rand(gen, (m * v, t), dtype), stride)
    a4, b4 = block_decompose(A, m, 2), block_decompose(B, m, 1)
    ca, cb = _rand(gen, (K, 2 * m), dtype), _rand(gen, (K, m), dtype)
    wide = 16 if stride == "aligned" else 2
    width = coded_fused.copy_bytes(2, *(
        (x.data_ptr(), coded_fused._block_offsets(x)[0], x.stride(-2)) for x in (a4, b4)))
    assert width == wide
    assert [_encode_form(x) for x in (a4, b4)] == [wide, wide]
    Y = ops.fused_worker(ca, cb, a4, b4)
    at, bt = ops.encode(ca, a4), ops.encode(cb, b4)
    assert coded_fused.copy_bytes(2, (at.data_ptr(), (0,), at.stride(1)),
                                  (bt.data_ptr(), (0,), bt.stride(1))) == wide
    staged = torch.stack([ops.matmul_t(at[k], bt[k]) for k in range(K)])
    torch.cuda.synchronize()
    assert Y.dtype == dtype and bool(torch.isfinite(Y).all())
    assert torch.equal(Y, staged)
    assert ops.launch_counts() == dict(_NONE, fused_worker=1, encode=2, matmul_t=K)


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


def _tile_form(ca, cb, a, b):
    """Kernel 1 in its tile form (one block a tile), whatever the call."""
    out, cluster = coded_fused.fused_worker_cuda(ca, cb, a, b, cluster=False)
    assert not cluster
    return out


def _cluster_case(case):
    """Operands on which ops.fused_worker takes kernel 1's float64 cluster
    form: random normal values, so every coded sum rounds."""
    gen = torch.Generator(device="cuda").manual_seed(31)

    def t(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64, device="cuda")

    if case == "main":       # the benchmark's product: 2 x 2 views of 8000^2
        A, B = t(8000, 8000), t(8000, 8000)
        return t(10, 4), t(10, 4), block_decompose(A, 2, 2), block_decompose(B, 2, 2)
    if case == "ragged":     # odd tile counts (3 x 5), v not a step multiple
        return t(10, 4), t(10, 4), t(4, 1001, 300), t(4, 1001, 520)
    if case == "p3_q4":
        return t(6, 3), t(6, 4), t(3, 257, 384), t(4, 257, 260)
    if case == "k1":         # one worker, as a mesh rank sends
        return t(1, 4), t(1, 4), t(4, 777, 1000), t(4, 777, 1000)
    # strided block views: 2 x 2 blocks of (514, 600) and of (514, 796)
    a, b = block_decompose(t(514, 600), 2, 2), block_decompose(t(514, 796), 2, 2)
    assert not a.is_contiguous() and not b.is_contiguous()
    return t(5, 4), t(5, 4), a, b


@pytest.mark.parametrize("case", ["main", "ragged", "p3_q4", "k1", "views"])
def test_cluster_form_equals_the_tile_form_bit_for_bit(cuda, case):
    """Kernel 1's float64 cluster form (2 x 2 blocks splitting the encode)
    gives the tile form's bits: the same FMA chain over the same raw
    blocks, the same DMMA loop, at the benchmark's shape and at ragged
    ones; and the launch counts as one of each."""
    ca, cb, a, b = _cluster_case(case)
    out = ops.fused_worker(ca, cb, a, b)
    assert ops.launch_counts() == dict(_NONE, fused_worker=1, **{ops.CLUSTER_LAUNCHES: 1})
    assert torch.equal(out, _tile_form(ca, cb, a, b))


def test_cluster_form_replays_in_a_cuda_graph(cuda):
    """The cluster launch captured in a CUDA graph: replays on new values in
    the captured operands equal the tile form bit for bit, and count no
    launch."""
    ca, cb, a, b = _cluster_case("ragged")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.fused_worker(ca, cb, a, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.fused_worker(ca, cb, a, b)
    assert ops.launch_counts() == dict(_NONE, fused_worker=2, **{ops.CLUSTER_LAUNCHES: 2})
    gen = torch.Generator(device="cuda").manual_seed(41)
    for _ in range(3):
        for x in (ca, cb, a, b):
            x.copy_(torch.randn(x.shape, generator=gen, dtype=x.dtype, device="cuda"))
        graph.replay()
        assert torch.equal(out, _tile_form(ca, cb, a, b))
    assert ops.launch_counts()[ops.CLUSTER_LAUNCHES] == 2


@pytest.mark.parametrize("stride", ["aligned", "odd"])
@pytest.mark.parametrize("data", ["random", "integer"])
@pytest.mark.parametrize("dtype", HALF)
def test_fused_kernel_takes_half_precision(cuda, dtype, data, stride):
    """bf16 / f16 run the kernel (FP32 sums, the coded tiles rounded once to
    the input dtype, the result once to its output dtype) and match the
    plain version, in both copy forms (16-byte copies, 2-byte loads); the
    float32 output is the FP32 sums themselves."""
    gen = torch.Generator().manual_seed(0)
    K, P, Q, v, r, t = 6, 8, 2, 300, 200, 150
    ca, cb = _data(gen, (K, P), dtype, data), _data(gen, (K, Q), dtype, data)
    a = _with_row_stride(_data(gen, (P, v, r), dtype, data), stride)
    b = _with_row_stride(_data(gen, (Q, v, t), dtype, data), stride)
    width = coded_fused.copy_bytes(a.element_size(), *(
        (x.data_ptr(), coded_fused._block_offsets(x)[0], x.stride(-2)) for x in (a, b)))
    assert width == (16 if stride == "aligned" else 2)
    _check(ops.fused_worker(ca, cb, a, b), ref.fused_worker_ref(ca, cb, a, b), data)
    wide = ops.fused_worker(ca, cb, a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    exp = ref.fused_worker_ref(ca, cb, a, b, torch.float32)
    assert wide.dtype == torch.float32
    assert float((wide - exp).abs().max()) <= 1e-5 * float(exp.abs().max())
    assert ops.launch_counts()["fused_worker"] == 2


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
        assert ops.launch_counts() == dict(_NONE, fused_worker=i + 1, decode=i + 1)
    C_ref = cm.with_backend("reference")(A, B, erased=[3, 8])
    torch.testing.assert_close(C_ref.cpu(), A.T @ B, rtol=0, atol=0)
    assert ops.launch_counts() == dict(_NONE, fused_worker=3, decode=3)


# every count of ops.launch_counts() at 0, kernel 1's cluster form included
_NONE = {name: 0 for name in ("fused_worker", "decode", "decode_partial",
                              "encode", "matmul_t", "wkv_scan", "mamba_scan",
                              ops.CLUSTER_LAUNCHES)}


@pytest.mark.parametrize("P,grid,rows,cols,K", [
    (4, (4,), 64, 256, 10),
    (3, (3,), 37, 129, 5),        # ragged, off the 256-wide thread block
    (1, (1,), 1, 1, 1),
    (20, (4, 5), 9, 33, 17),      # K past the 16 register rows, P past 8 loads
    # the 16-byte form's edges (bf16/f16): cols % 8 == 0 with ragged rows
    (4, (2, 2), 37, 264, 10),
    # the flat form with E % 8 == 0, E off a block's span (2048 elements)
    (4, (4,), 1, 8 * 2053, 10),
    # P past one group of 8 loads, K past groups of 4 workers
    (20, (4, 5), 9, 40, 17),
    (4, (4,), 16, 64, 17),
    # P = 64 with the panel at its 48 KB limit (K = 384 in bf16/f16)
    (64, (8, 8), 3, 24, "limit"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, *HALF])
def test_encode_kernel_matches_plain(cuda, P, grid, rows, cols, K, dtype):
    """Each shape in the form its layout picks (asserted): bf16/f16 with
    cols % 8 == 0 in the 16-byte form, all else one element a thread.  The
    (P, E) form of the same blocks gives the same bits; bf16/f16 also with
    integer inputs, exactly."""
    if K == "limit":
        K = coded_encode.MAX_PANEL_BYTES // (P * (torch.finfo(dtype).bits // 8))
    gen = torch.Generator().manual_seed(5)
    half = dtype in HALF
    for data in ("random", "integer") if half else ("random",):
        coeff = _data(gen, (K, P), dtype, data)
        blocks = _data(gen, (*grid, rows, cols), dtype, data)
        form = 16 if half and cols % 8 == 0 else blocks.element_size()
        assert _encode_form(blocks) == form
        assert _encode_form(blocks.reshape(P, -1)) == (16 if half and rows * cols % 8 == 0
                                                       else blocks.element_size())
        ops.reset_launch_counts()
        out = ops.encode(coeff, blocks)
        exp = ref.encode_ref(coeff, blocks.reshape(P, -1)).reshape(K, rows, cols)
        torch.cuda.synchronize()
        assert out.shape == (K, rows, cols) and out.dtype == dtype
        if half:
            _check(out, exp, data)
        else:
            scale = float(exp.abs().max()) + 1e-9
            assert float((out - exp).abs().max()) / scale < TOL[dtype]
        flat = ops.encode(coeff, blocks.reshape(P, -1))        # the (P, E) form
        assert flat.shape == (K, rows * cols)
        torch.testing.assert_close(flat, out.reshape(K, -1), rtol=0, atol=0)
        assert ops.launch_counts() == dict(_NONE, encode=2)


def test_encode_kernel_on_strided_block_views_is_exact(cuda):
    """Integer blocks: the strided view and its contiguous stack encode to
    the plain version's values exactly."""
    gen = torch.Generator().manual_seed(6)
    A = torch.randint(-9, 10, (130, 250), generator=gen).to(cuda, torch.float64)
    coeff = torch.randint(-3, 4, (7, 4), generator=gen).to(cuda, torch.float64)
    view = block_decompose(A, 2, 2)
    assert not view.is_contiguous()
    out = ops.encode(coeff, view)
    stacked = view.reshape(4, 65, 125).contiguous()
    torch.testing.assert_close(out, ops.encode(coeff, stacked), rtol=0, atol=0)
    torch.testing.assert_close(
        out, ref.encode_ref(coeff, stacked.reshape(4, -1)).reshape(7, 65, 125),
        rtol=0, atol=0)


@pytest.mark.parametrize("v,r,t", [(256, 128, 128), (300, 200, 150),
                                   (129, 257, 65), (1, 1, 1), (0, 9, 7),
                                   (5, 129, 257),       # v below one 16-row step
                                   (100, 4000, 129),    # v not a multiple of 16
                                   (33, 257, 4000)])
@pytest.mark.parametrize("stride", ["aligned", "odd"])
@pytest.mark.parametrize("data", ["random", "integer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, *HALF])
def test_matmul_t_kernel_matches_plain(cuda, v, r, t, stride, data, dtype):
    gen = torch.Generator().manual_seed(7)
    A = _with_row_stride(_data(gen, (v, r), dtype, data), stride)
    B = _with_row_stride(_data(gen, (v, t), dtype, data), stride)
    width = coded_fused.copy_bytes(A.element_size(), (A.data_ptr(), (0,), A.stride(0)),
                                   (B.data_ptr(), (0,), B.stride(0)))
    assert width == (16 if stride == "aligned" else A.element_size())
    out = ops.matmul_t(A, B)
    _check(out, ref.matmul_t_ref(A, B), data)
    Y = torch.full((2, r, t), float("nan"), device=cuda, dtype=dtype)
    ops.matmul_t(A, B, out=Y[1])
    torch.testing.assert_close(Y[1], out, rtol=0, atol=0)
    assert bool(Y[0].isnan().all())
    assert ops.launch_counts() == dict(_NONE, matmul_t=2)


def test_matmul_t_kernel_on_row_strided_operands(cuda):
    """Rows of A and B may be strided (a column slice of a wider matrix)."""
    gen = torch.Generator().manual_seed(8)
    wide = torch.randint(-9, 10, (70, 300), generator=gen).to(cuda, torch.float64)
    A, B = wide[:, 10:110], wide[:, 150:217]
    assert not A.is_contiguous()
    torch.testing.assert_close(ops.matmul_t(A, B), A.T @ B, rtol=0, atol=0)


@pytest.mark.parametrize("stride", ["aligned", "odd"])
@pytest.mark.parametrize("data", ["random", "integer"])
@pytest.mark.parametrize("dtype", HALF)
def test_new_kernels_take_half_precision(cuda, dtype, data, stride):
    """bf16 / f16 encode (kernel 4, written in the coefficient dtype) and
    block matmul (kernel 5) against their plain versions in both copy
    forms; the per-chunk decode still takes float64 / float32 only."""
    gen = torch.Generator().manual_seed(9)
    c = _data(gen, (7, 5), dtype, data)
    x = _with_row_stride(_data(gen, (5, 37, 1031), dtype, data), stride)
    _check(ops.encode(c, x), ref.encode_ref(c, x.reshape(5, -1)).reshape(7, 37, 1031), data)
    A = _with_row_stride(_data(gen, (300, 257), dtype, data), stride)
    B = _with_row_stride(_data(gen, (300, 65), dtype, data), stride)
    width = coded_fused.copy_bytes(A.element_size(), (A.data_ptr(), (0,), A.stride(0)),
                                   (B.data_ptr(), (0,), B.stride(0)))
    assert width == (16 if stride == "aligned" else 2)
    _check(ops.matmul_t(A, B), ref.matmul_t_ref(A, B), data)
    assert ops.launch_counts() == dict(_NONE, encode=1, matmul_t=1)
    h = torch.ones(2, 8, 8, device=cuda, dtype=dtype)
    with pytest.raises(NotImplementedError, match="float64 or float32"):
        ops.decode_partial(h[:, :4, :2], h.transpose(1, 2)[:, :2, :], 4.0)


def _partial_form(Y, y_off, ys, widths):
    """The copy form the per-chunk kernel takes for Y (a fresh output is
    aligned)."""
    return ("bulk" if coded_decode.bulk_copies(Y.element_size(), (Y.data_ptr(),), y_off,
                                               (ys,), widths) else "element")


# (Q, mn, K, Ec): odd and aligned widths, mn = 20 past the 16 register rows
# (two passes over a tile's 11 rows, resident in shared memory), mn = 24
# with K = 64 (too many rows to stay resident: each pass copies them again),
# K = 700 over many row groups (a 44.8 KB float64 panel), Q = 1, Q = 128
# chunks narrower than one tile
_STACKS = [(5, 20, 11, 1031), (5, 20, 11, 1032), (2, 24, 64, 1032), (3, 8, 700, 2048),
           (1, 4, 10, 4096), (128, 4, 10, 64), (4, 2, 6, 130)]


@pytest.mark.parametrize("Q,mn,K,Ec", _STACKS)
@pytest.mark.parametrize("extract", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decode_partial_kernel_equals_per_chunk_decode(cuda, Q, mn, K, Ec, extract, dtype):
    """Random (non-integer) data: the per-chunk kernel must agree with the
    decode kernel on each chunk BIT FOR BIT, as one launch for all chunks, in
    either copy form (the stack's offsets are multiples of Ec)."""
    gen = torch.Generator().manual_seed(9)
    W = _rand(gen, (Q, mn, K), dtype)
    Y = _rand(gen, (Q, K, Ec), dtype) * 1000
    form = _partial_form(Y, [q * K * Ec for q in range(Q)], Ec, [Ec])
    assert form == ("bulk" if Ec * Y.element_size() % 16 == 0 else "element")
    out = ops.decode_partial(W, Y, 64.0, extract=extract)
    assert out.shape == (Q, mn, Ec) and ops.launch_counts()["decode_partial"] == 1
    per_chunk = torch.stack([ops.decode(W[q], Y[q], 64.0, extract=extract)
                             for q in range(Q)])
    torch.testing.assert_close(out, per_chunk, rtol=0, atol=0)


# (dtype, bounds, form, nan): Y (K, bounds[-1]); chunks of width 0 and
# narrower than one tile (512 float64 or 1024 float32 columns)
_BOUNDS = [
    (torch.float64, [0, 1025, 2050, 3075, 4099], "element", False),
    (torch.float64, [0, 1024, 2048, 3072, 4096], "bulk", False),
    (torch.float32, [0, 2048, 2048, 6144, 8192], "bulk", False),
    (torch.float64, [0, 0, 16, 528, 1040], "bulk", False),
    (torch.float32, [0, 1, 1, 3000, 4099], "element", False),
    (torch.float64, [0, 1024, 2048, 3072, 4096], "bulk", True),
    (torch.float32, [0, 1025, 2050, 3075, 4099], "element", True),
]


@pytest.mark.parametrize("dtype,bounds,form,nan", _BOUNDS)
@pytest.mark.parametrize("extract", [True, False])
def test_decode_partial_kernel_unequal_chunks(cuda, dtype, bounds, form, nan, extract):
    """Y (K, E) as the runtime holds it, chunks that differ in width: equal
    to the plain version (integer data, exact) and to the decode kernel
    on each column slice, bit for bit.  With ``nan``, a NaN in a row whose
    panel column is 0 (an erased worker) still reaches C: every row of Y
    is read, as the reference reads it."""
    gen = torch.Generator().manual_seed(10)
    Q, mn, K, E = 4, 6, 9, bounds[-1]
    W = torch.randint(-2, 3, (Q, mn, K), generator=gen).to(cuda, dtype)
    Y = torch.randint(-40, 41, (K, E), generator=gen).to(cuda, dtype)
    if nan:
        W[:, :, 3] = 0                      # worker 3 erased in every chunk
        Y[3, ::7] = float("nan")
    widths = [b1 - b0 for b0, b1 in zip(bounds, bounds[1:])]
    assert _partial_form(Y, bounds[:-1], E, widths) == form
    out = ops.decode_partial(W, Y, 64.0, extract=extract, bounds=bounds)
    assert out.shape == (mn, E)
    exp = ref.decode_partial_ref(W, Y, 64.0, extract, bounds)
    torch.testing.assert_close(out, exp, rtol=0, atol=0, equal_nan=nan)
    assert torch.equal(torch.isnan(out), torch.isnan(exp))
    assert bool(torch.isnan(out).any()) == nan
    for q in range(Q):
        cols = slice(bounds[q], bounds[q + 1])
        torch.testing.assert_close(out[:, cols],
                                   ops.decode(W[q], Y[:, cols], 64.0, extract=extract),
                                   rtol=0, atol=0, equal_nan=nan)


@pytest.mark.parametrize("backend", ["staged", "fused"])
@pytest.mark.parametrize("kind,p,m,n,pp", [("bec", 2, 2, 2, 1),
                                           ("tradeoff", 4, 2, 1, 2),
                                           ("polycode", 2, 2, 1, 1)])
def test_staged_and_partial_on_the_card_are_exact(cuda, backend, kind, p, m, n, pp):
    gen = torch.Generator().manual_seed(11)
    v, r, t = 8 * p + 3, 45, 33
    A = torch.randint(-3, 4, (v, r), generator=gen).to(torch.float64)
    B = torch.randint(-3, 4, (v, t), generator=gen).to(torch.float64)
    plan = make_plan(kind, p, m, n, K=9, L=v * 9 + 1, p_prime=pp,
                     points="chebyshev")
    cm = CodedMatmul(plan, backend)
    C0 = A.T @ B
    per_request = (dict(encode=2, matmul_t=plan.K) if backend == "staged"
                   else dict(fused_worker=1))
    torch.testing.assert_close(cm(A, B, erased=[0, 4]).cpu(), C0, rtol=0, atol=0)
    assert ops.launch_counts() == dict(_NONE, decode=1, **per_request)
    ops.reset_launch_counts()
    prog = np.ones(plan.K)
    prog[[0, 1]] = 0.75
    C = cm(A, B, progress=prog, sub_tasks=4)
    torch.testing.assert_close(C.cpu(), C0, rtol=0, atol=0)
    assert ops.launch_counts() == dict(_NONE, decode_partial=1, **per_request)
    Y = cm.worker_stage(A, B)
    torch.testing.assert_close(cm.decode_stage(Y, (r, t), erased=[3]).cpu(), C0,
                               rtol=0, atol=0)


def _close(out, exp, tol=1e-4):
    """max |out - exp| / max |exp| within ``tol`` (float32 sums in another
    order: the kernels sum step by step, the plain versions by chunks)."""
    assert out.shape == exp.shape and out.dtype == exp.dtype
    scale = float(exp.abs().max()) + 1e-9
    assert float((out - exp).abs().max()) / scale < tol


@pytest.mark.parametrize("B,S,H,dk,dv,chunk", [
    (2, 64, 3, 8, 8, 16),
    (1, 48, 2, 16, 16, 8),
    (2, 100, 3, 16, 16, 64),      # chunk halved to 4; tiles of 32 steps ragged
    (1, 37, 2, 64, 64, 64),       # S odd: chunk 1, 37 chunk states
    (2, 130, 5, 64, 64, 64),
    (1, 33, 2, 32, 40, 16),       # dv off the warp, dv != dk
    # ragged column groups (32 columns a block): the last group 8, 8, 32 wide
    (2, 70, 3, 64, 40, 64),
    (1, 50, 2, 64, 72, 16),
    (2, 40, 2, 64, 128, 8),
    # every dk with its lane count (2 lanes at dk=8, 4 at 16, 8 above), dv = dk
    (2, 50, 3, 8, 8, 64),
    (2, 50, 3, 16, 16, 64),
    (2, 50, 3, 32, 32, 64),
    (1, 50, 2, 32, 100, 64),      # dv off 32 and off 4: one-float copies
    # S shorter than one 16-step tile, and chunk 1 (S odd)
    (2, 5, 3, 64, 64, 64),
    (1, 16, 2, 16, 16, 64),       # exactly one tile
    (2, 7, 2, 64, 40, 64),        # chunk 1, ragged group, one short tile
    (1, 33, 3, 8, 24, 1),         # chunk 1 asked for
])
def test_wkv_kernel_matches_plain(cuda, B, S, H, dk, dv, chunk):
    gen = torch.Generator().manual_seed(12)
    w = torch.exp(-torch.exp(torch.randn((B, S, H, dk), generator=gen))).to(cuda)
    k, r = (torch.randn((B, S, H, dk), generator=gen).to(cuda) for _ in range(2))
    v = torch.randn((B, S, H, dv), generator=gen).to(cuda)
    u = torch.randn((H, dk), generator=gen).to(cuda)
    out = ops.wkv_scan(w, k, v, r, u, chunk=chunk)
    exp = ref.wkv_scan_ref(w, k, v, r, u, chunk)
    torch.cuda.synchronize()
    for o, e in zip(out, exp):
        _close(o, e)
    assert ops.launch_counts() == dict(_NONE, wkv_scan=1)


def test_wkv_kernel_one_float_copies_on_unaligned_inputs(cuda):
    """Inputs that start 4 bytes past a 16-byte boundary take the one-float
    copies and give exactly what the same values 16-byte aligned give."""
    def off_by_one_float(x):
        view = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
        return view.copy_(x)

    gen = torch.Generator().manual_seed(15)
    B, S, H, dk = 2, 40, 3, 64
    w = torch.exp(-torch.exp(torch.randn((B, S, H, dk), generator=gen))).to(cuda)
    k, v, r = (torch.randn((B, S, H, dk), generator=gen).to(cuda) for _ in range(3))
    u = torch.randn((H, dk), generator=gen).to(cuda)
    shifted = [off_by_one_float(t) for t in (w, k, v, r)]
    assert wkv_scan.copy_elems(dk, *(t.data_ptr() for t in shifted)) == 1
    assert wkv_scan.copy_elems(dk, *(t.data_ptr() for t in (w, k, v, r))) == 4
    out = ops.wkv_scan(*shifted, u)
    aligned = ops.wkv_scan(w, k, v, r, u)
    exp = ref.wkv_scan_ref(w, k, v, r, u)
    torch.cuda.synchronize()
    for o, a, e in zip(out, aligned, exp):
        _close(o, e)
        assert torch.equal(o, a)


@pytest.mark.parametrize("B,S,d,s,chunk,init", [
    (2, 64, 32, 8, 16, "random"),
    (1, 128, 16, 4, 32, "random"),
    (3, 48, 24, 16, 16, "random"),
    (2, 100, 300, 16, 128, "random"),   # chunk halved to 4, d off the 64-thread block
    (1, 37, 130, 32, 128, "random"),    # S odd: chunk 1
    (2, 5, 200, 16, 128, "random"),     # S shorter than one 16-step tile, chunk 5
    (1, 16, 128, 8, 128, "random"),     # exactly one tile
    (2, 33, 64, 4, 1, "random"),        # chunk 1 asked for, a short last tile
    (2, 1024, 256, 16, 128, "jamba_init"),
])
def test_mamba_kernel_matches_plain(cuda, B, S, d, s, chunk, init):
    """``jamba_init`` is the long-memory regime of the Jamba initialisation
    (models/mamba.py): dt = softplus(about -4.6), so dt is near 0.01, and
    A_log = log(1..16), so each step's decay is 0.84-0.99 and the state
    remembers about 100 steps; the one-MUFU exponentials must still hold
    1e-4 over 1024 steps."""
    gen = torch.Generator().manual_seed(13 if init == "random" else 16)
    if init == "random":
        dt = torch.nn.functional.softplus(torch.randn((B, S, d), generator=gen))
    else:
        dt = torch.nn.functional.softplus(0.5 * torch.randn((B, S, d), generator=gen) - 4.6)
    x = torch.randn((B, S, d), generator=gen)
    Bm, Cm = (torch.randn((B, S, s), generator=gen) for _ in range(2))
    if init == "random":
        A_log = torch.rand((d, s), generator=gen) * 0.9 + 0.1
        D = torch.randn((d,), generator=gen)
    else:
        A_log = torch.log(torch.arange(1, s + 1, dtype=torch.float32)).expand(d, s)
        D = torch.ones((d,))
    dt, x, Bm, Cm, A_log, D = (t.to(cuda) for t in (dt, x, Bm, Cm, A_log, D))
    out = ops.mamba_scan(dt, x, Bm, Cm, A_log, D, chunk=chunk)
    exp = ref.mamba_scan_ref(dt, x, Bm, Cm, A_log, D, chunk)
    torch.cuda.synchronize()
    for o, e in zip(out, exp):
        _close(o, e)
    assert ops.launch_counts() == dict(_NONE, mamba_scan=1)


def test_scan_kernels_refuse_what_they_do_not_take(cuda):
    """What the scan kernels refuse: other dtypes than float32,
    mismatched shapes and an empty sequence.  A head width or a state size
    off their instances (dk 12, s 3) is no longer refused: it is padded to
    the next instance and held against the plain version."""
    with pytest.raises(ValueError, match="float32"):
        ops.wkv_scan(*(torch.zeros(1, 8, 2, 8, device=cuda, dtype=torch.bfloat16),) * 4,
                     torch.zeros(2, 8, device=cuda))
    z = torch.zeros(1, 8, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.wkv_scan(z, z, z, z, torch.zeros(3, 8, device=cuda))
    with pytest.raises(ValueError, match="S >= 1"):
        ops.mamba_scan(*(torch.zeros(1, 0, 4, device=cuda),) * 2,
                       *(torch.zeros(1, 0, 4, device=cuda),) * 2,
                       torch.zeros(4, 4, device=cuda), torch.zeros(4, device=cuda))
    assert not any(ops.launch_counts().values())
    gen = torch.Generator().manual_seed(3)
    w = torch.exp(-torch.exp(torch.randn(1, 40, 2, 12, generator=gen)))
    k, r = (torch.randn(1, 40, 2, 12, generator=gen) for _ in range(2))
    v, u = torch.randn(1, 40, 2, 20, generator=gen), torch.randn(2, 12, generator=gen)
    args = [t.to(cuda) for t in (w, k, v, r, u)]
    for o, e in zip(ops.wkv_scan(*args), ref.wkv_scan_ref(*args)):
        _close(o, e)
    x = torch.randn(1, 40, 4, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(1, 40, 4, generator=gen))
    Bm, Cm = (torch.randn(1, 40, 3, generator=gen) for _ in range(2))
    A_log, D = torch.rand(4, 3, generator=gen) * 0.9 + 0.1, torch.randn(4, generator=gen)
    args = [t.to(cuda) for t in (dt, x, Bm, Cm, A_log, D)]
    for o, e in zip(ops.mamba_scan(*args), ref.mamba_scan_ref(*args)):
        _close(o, e)
    assert ops.launch_counts() == dict(_NONE, wkv_scan=1, mamba_scan=1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_1_5_large_398b"])
def test_smoke_model_with_kernels_matches_without(cuda, arch, dtype, tol):
    """A SMOKE-size model on the card: prefill with the scan kernels against
    the plain chunked path on the same weights (the bonus u, the decay base
    and the step-size bias perturbed), one launch per rwkv / mamba layer,
    and a decode step from each cache."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=None, dtype=dtype,
                              pattern=tuple((m, "mlp" if f == "moe" else f)
                                            for m, f in cfg.pattern))
    on = dataclasses.replace(cfg, rwkv_kernel=True, mamba_kernel=True)
    params = init_params(cfg, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(14)
    for block in params.blocks:
        for name in ("u", "w_decay_base", "dt_bias"):
            if name in block.mixer:
                block.mixer[name].add_(torch.randn(block.mixer[name].shape, generator=gen,
                                                   device=cuda))
    toks = torch.randint(0, cfg.vocab, (2, 97), generator=gen, device=cuda)
    off_logits, off_cache = prefill(params, cfg, {"tokens": toks[:, :96]}, S_max=97)
    assert not any(ops.launch_counts().values())
    on_logits, on_cache = prefill(params, on, {"tokens": toks[:, :96]}, S_max=97)
    n_scan = sum(m in ("rwkv", "mamba") for m, _ in cfg.pattern) * cfg.n_groups
    counts = ops.launch_counts()
    assert counts["wkv_scan"] + counts["mamba_scan"] == n_scan
    _close(on_logits, off_logits, tol)
    for a, b in zip(on_cache, off_cache):
        for name in b:
            _close(a[name].float(), b[name].float(), tol)
    dec_on, _ = decode_step(params, on, on_cache, {"tokens": toks[:, 96:]}, 96)
    dec_off, _ = decode_step(params, cfg, off_cache, {"tokens": toks[:, 96:]}, 96)
    _close(dec_on, dec_off, tol)
    assert ops.launch_counts() == counts          # decode launches no kernel


@pytest.mark.parametrize("scan,S", [("wkv", 200), ("wkv", 128), ("mamba", 200), ("mamba", 256)])
def test_scan_backward_through_the_kernel_matches_autograd(cuda, scan, S):
    """WkvFused / MambaScanFused on the card (the kernel forward, the plain
    PyTorch reverse chunk scan backward) against autograd through the plain
    scans, every input's gradient within 1e-4 of its largest value, at
    chunks of the kernel's size and at S = 200 (chunks halved to 8); one
    launch each."""
    gen = torch.Generator(device=cuda).manual_seed(21)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    if scan == "wkv":
        x = (torch.exp(-torch.exp(rand(2, S, 3, 64))), rand(2, S, 3, 64), rand(2, S, 3, 40),
             rand(2, S, 3, 64), rand(3, 64))
        fused, plain = WkvFused.apply, ref.wkv_scan_ref
    else:
        x = (torch.nn.functional.softplus(rand(2, S, 300) - 2.0), rand(2, S, 300),
             rand(2, S, 16), rand(2, S, 16), torch.rand((300, 16), generator=gen, device=cuda),
             rand(300))
        fused, plain = MambaScanFused.apply, ref.mamba_scan_ref
    grads = []
    for fn in (fused, plain):
        ts = [t.clone().requires_grad_() for t in x]
        y, fin = fn(*ts)[:2]
        torch.sum(y * torch.cos(y)).add(torch.sum(fin)).backward()
        grads.append([t.grad for t in ts])
    for g, e in zip(*grads):
        _close(g, e)
    assert ops.launch_counts() == dict(_NONE, **{f"{scan}_scan": 1})


@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_1_5_large_398b"])
def test_smoke_train_step_with_kernels_matches_without(cuda, arch):
    """A SMOKE model's loss and every gradient on the card, float32, through
    the scan kernels against the plain path on the same weights: the loss
    within 1e-5, each leaf within 1e-3 of its largest value; the kernel
    launched twice a scan layer (the forward and remat's recomputation)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    on = dataclasses.replace(cfg, rwkv_kernel=True, mamba_kernel=True)
    params = init_params(cfg, seed=4, device=cuda)
    params.requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(22)
    toks = torch.randint(0, cfg.vocab, (2, 128), generator=gen, device=cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = []
    for c in (on, cfg):
        loss = train_loss(params, c, batch)
        out.append((loss.item(), torch.autograd.grad(loss, list(params.parameters()))))
    n_scan = sum(m in ("rwkv", "mamba") for m, _ in cfg.pattern) * cfg.n_groups
    assert sum(ops.launch_counts().values()) == 2 * n_scan
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    for g, e in zip(out[0][1], out[1][1]):
        _close(g, e, 1e-3)


@pytest.mark.parametrize("arch", ["gemma3_12b", "qwen2_moe_a2_7b", "qwen3_moe_235b_a22b",
                                  "jamba_1_5_large_398b"])
def test_smoke_model_on_the_card_matches_the_cpu(cuda, arch):
    """Sliding-window attention (gemma3: window 16, a 40-token prompt, the
    band past key 0 and the ring primed past its slots, then 20 decode
    steps around the ring) and the dense MoE FFN (the qwen MoEs, Jamba with
    its experts), float32: the same weights and tokens on the card and on
    the CPU, prefill and every decode step within 1e-4.  Each card step
    starts from the CPU's cache; Jamba's conv state is stored in bf16
    whatever the config's dtype, so it is held to one bf16 step of its
    largest value."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", q_chunk=8)
    on_cpu = init_params(cfg, seed=3, device="cpu")
    on_card = copy.deepcopy(on_cpu).to(cuda)
    gen = torch.Generator().manual_seed(15)
    S, n_dec = 40, 20
    toks = torch.randint(0, cfg.vocab, (2, S + n_dec), generator=gen)

    def close_caches(card, cpu):
        for a, b in zip(card, cpu):
            for name in b:
                tol = 2.0 ** -7 if b[name].dtype == torch.bfloat16 else 1e-4
                _close(a[name].float().cpu(), b[name].float(), tol)

    lc, cc = prefill(on_cpu, cfg, {"tokens": toks[:, :S]}, S_max=S + n_dec)
    lg, cg = prefill(on_card, cfg, {"tokens": toks[:, :S].to(cuda)}, S_max=S + n_dec)
    _close(lg.cpu(), lc)
    close_caches(cg, cc)
    for i in range(n_dec):
        step = toks[:, S + i:S + i + 1]
        cg = [{k: v.to(cuda) for k, v in c.items()} for c in cc]
        lg, cg = decode_step(on_card, cfg, cg, {"tokens": step.to(cuda)}, S + i)
        lc, cc = decode_step(on_cpu, cfg, cc, {"tokens": step}, S + i)
        _close(lg.cpu(), lc)
        close_caches(cg, cc)
    if cfg.window is not None:
        assert cc[0]["k"].shape[1] == cfg.window      # a ring, wrapped
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("n_experts,top_k,n_shared,ep_size", [
    (4, 2, 0, 1), (6, 2, 2, 4), (60, 4, 4, 16)])
def test_apply_moe_on_the_card_matches_the_cpu(cuda, n_experts, top_k, n_shared, ep_size,
                                               dtype, tol):
    """apply_moe at SMOKE width (d 64, d_ff 96): the card against the CPU
    on the same parameters and tokens.  Expert ids and outputs are held on
    every token whose top-k probability gap exceeds 1e-5 (two float32
    router products may swap a nearly tied pair); the others are counted."""
    cfg = MoEConfig(n_experts=n_experts, top_k=top_k, d_expert_ff=96, n_shared=n_shared)
    params = init_moe(torch.Generator().manual_seed(4), 64, cfg, ep_size=ep_size, dtype=dtype)
    x = torch.randn((2, 48, 64), generator=torch.Generator().manual_seed(5)).to(dtype)
    y, aux = apply_moe(params, x, cfg)
    yg, auxg = apply_moe({k: v.to(cuda) for k, v in params.items()}, x.to(cuda), cfg)
    assert yg.dtype == dtype and yg.shape == y.shape
    assert abs(float(auxg) - float(aux)) <= 1e-5 * abs(float(aux))
    xf = x.reshape(-1, 64)
    probs = torch.softmax(xf.double() @ params["router"].double(), -1)
    top = probs[:, :n_experts].topk(top_k + 1).values
    far = (top[:, top_k - 1] - top[:, top_k]) > 1e-5
    print(f"{int((~far).sum())} of {len(far)} tokens within 1e-5 of a top-k tie")
    e_cpu = _route(params["router"], xf, cfg)[1].sort(-1).values
    e_card = _route(params["router"].to(cuda), xf.to(cuda), cfg)[1].sort(-1).values.cpu()
    assert torch.equal(e_card[far], e_cpu[far])
    _close(yg.reshape(-1, 64)[far.to(cuda)].float().cpu(), y.reshape(-1, 64)[far].float(), tol)


def test_serve_cli_on_the_card_serves_gemma3():
    """``python -m repro_torch.launch.serve --arch gemma3_12b --smoke`` on the
    card (its default device): a 32-token prompt against a window of 16,
    16 greedy tokens through the rings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the serve CLI defaults to the card)")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "gemma3_12b", "--smoke"], env=env, cwd=str(root),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == (f"arch=gemma3-smoke batch=4 prompt=32 gen=16 "
                        f"device={torch.cuda.get_device_name(0)}")
    sample = ast.literal_eval(lines[-1].removeprefix("sample: "))
    assert len(sample) == 12 and all(0 <= t < 512 for t in sample)


# -- observability on the card -------------------------------------------------

@pytest.fixture
def obs_off():
    obs.disable()
    yield
    obs.disable()


def _bits(x):
    return x.contiguous().view(torch.int64).cpu()


def _obs_problem():
    gen = torch.Generator().manual_seed(21)
    A = torch.randint(0, 6, (256, 96), generator=gen).to("cuda", torch.float64)
    B = torch.randint(0, 6, (256, 80), generator=gen).to("cuda", torch.float64)
    plan = make_plan("bec", 2, 2, 2, K=10, L=256 * 25 + 1, points="equispaced")
    return A, B, plan


def test_obs_on_is_bit_identical_to_off(cuda, obs_off):
    """One fused and one partial request, obs off and then on: the same
    bits, and the same launches per request."""
    A, B, plan = _obs_problem()
    progress = np.r_[0.5, 0.75, 0.25, np.ones(7)]

    def serve():
        cm = CodedMatmul(plan, sub_tasks=4)
        before = ops.launch_counts()
        out = [cm(A, B, erased=[0, 2, 4, 6, 8, 9], sub_tasks=1),
               cm(A, B, progress=progress)]
        after = ops.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    off, launched_off = serve()
    obs.enable(fresh=True)
    on, launched_on = serve()
    assert launched_on == launched_off == dict(_NONE, fused_worker=2, decode=1,
                                               decode_partial=1)
    for a, b in zip(off, on):
        assert torch.equal(_bits(a), _bits(b))
        torch.testing.assert_close(a.cpu(), (A.T @ B).cpu(), rtol=0, atol=0)
    reg = obs.session().registry
    assert reg.value("kernel.call", op="decode_partial", traced=0) == 1


def _seven_calls_on_the_card():
    gen = torch.Generator().manual_seed(22)

    def t(*shape, dtype=torch.float64):
        return torch.randn(shape, generator=gen, dtype=dtype).to("cuda")

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen).to("cuda", torch.float64)

    ca, cb, a, b = t(4, 4), t(4, 2), t(4, 64, 40), t(2, 64, 24)
    W, Y, Ws, Ys = ints(4, 10), ints(10, 128), ints(2, 4, 10), ints(2, 10, 64)
    coeff, blocks = t(5, 3), t(3, 1024)
    f32 = dict(dtype=torch.float32)
    w = torch.exp(-torch.exp(t(1, 32, 2, 8, **f32)))
    k, r, v, u = (t(1, 32, 2, 8, **f32), t(1, 32, 2, 8, **f32),
                  t(1, 32, 2, 8, **f32), t(2, 8, **f32))
    dt = torch.nn.functional.softplus(t(1, 32, 64, **f32))
    x, Bs, Cs = t(1, 32, 64, **f32), t(1, 32, 4, **f32), t(1, 32, 4, **f32)
    A_log, D = t(64, 4, **f32).abs() + 0.1, t(64, **f32)
    return {
        "fused_worker": lambda: ops.fused_worker(ca, cb, a, b),
        "decode": lambda: ops.decode(W, Y, 64.0),
        "decode_partial": lambda: ops.decode_partial(Ws, Ys, 64.0),
        "encode": lambda: ops.encode(coeff, blocks),
        "matmul_t": lambda: ops.matmul_t(a[0], b[0]),
        "wkv_scan": lambda: ops.wkv_scan(w, k, v, r, u, chunk=8),
        "mamba_scan": lambda: ops.mamba_scan(dt, x, Bs, Cs, A_log, D, chunk=8),
    }


def test_kernel_call_counter_equals_launches(cuda, obs_off):
    """For every wrapper, ``kernel.call{op}`` equals the launch-count delta,
    and each call leaves one event-timed ``kernel.<op>`` span."""
    calls = _seven_calls_on_the_card()
    for call in calls.values():          # builds the libraries first
        call()
    obs.enable(fresh=True)
    ops.reset_launch_counts()
    for _ in range(3):
        for call in calls.values():
            call()
    counts = ops.launch_counts()
    reg, rec = obs.session().registry, obs.session().recorder
    for op in calls:
        assert reg.value("kernel.call", op=op, traced=0) == counts[op] == 3, op
        spans = rec.by_name(f"kernel.{op}")
        assert len(spans) == 3 and all(s.lane == "kernels" for s in spans)
        assert all(s.duration_s > 0 for s in spans), op


def test_event_timed_spans_lie_inside_the_request_wall(cuda, obs_off):
    A, B, plan = _obs_problem()
    cm = CodedMatmul(plan)
    cm(A, B, erased=[1])                 # builds, factors the first panel
    obs.enable(fresh=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm(A, B, erased=[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = obs.session().recorder
    spans = rec.by_name("kernel.fused_worker") + rec.by_name("kernel.decode")
    assert len(spans) == 2
    assert all(0 < s.duration_s < wall for s in spans)
    assert sum(s.duration_s for s in spans) < wall
    assert all(t0 <= s.start_s and s.end_s <= t0 + wall for s in spans)


def test_kernel_spans_wait_for_nothing_until_a_read(cuda, obs_off, monkeypatch):
    """Obs on, a fused and a partial request: no event, stream or device
    synchronize while they run (the session anchored the card's clock when
    it was enabled); at the read every ``kernel.<op>`` span is closed, lasts
    longer than 0 and lies inside its request's wall on the session clock,
    under that request's ``runtime.call``."""
    A, B, plan = _obs_problem()
    cm = CodedMatmul(plan, sub_tasks=4)
    progress = np.r_[0.5, 0.75, 0.25, np.ones(7)]
    requests = [lambda: cm(A, B, erased=[0, 2, 4, 6, 8, 9], sub_tasks=1),
                lambda: cm(A, B, progress=progress)]
    for request in requests:             # builds, factors the panels
        request()
    torch.cuda.synchronize()
    obs.enable(fresh=True)
    rec = obs.session().recorder

    def refuse(*args, **kwargs):
        raise AssertionError("a synchronize while the requests ran")

    walls = []
    with monkeypatch.context() as m:
        for owner in (torch.cuda, torch.cuda.Event, torch.cuda.Stream):
            m.setattr(owner, "synchronize", refuse)
        for request in requests:
            t0 = time.perf_counter()
            C = request()
            C.cpu()                      # waits by copying, not by a synchronize
            walls.append((t0, time.perf_counter()))
    by = {s.sid: s for s in rec.spans}
    calls = rec.by_name("runtime.call")
    kernels = [s for s in by.values() if s.name.startswith("kernel.")]
    assert len(calls) == 2 and not rec._pending
    assert sorted(s.name for s in kernels) == ["kernel.decode", "kernel.decode_partial",
                                               "kernel.fused_worker", "kernel.fused_worker"]
    for k in kernels:
        root = k
        while root.parent is not None:
            root = by[root.parent]
        t0, t1 = walls[calls.index(root)]
        assert k.duration_s > 0 and t0 <= k.start_s and k.end_s <= t1, k


# -- the adaptive control plane on the card ---------------------------------

_GOLDEN_DIR = Path(__file__).parent / "golden"


@pytest.mark.parametrize("key", ["heavy_tail", "crawler_partial",
                                 "pool_resize_grow"])
def test_golden_replay_on_the_fused_kernels(cuda, key):
    """A checked-in golden trace replays through the fused kernels with an
    empty diff: the backend moves no recorded field, every step exact."""
    from repro_torch.chaos import Trace
    from repro_torch.chaos.golden import replay_golden

    golden = Trace.load(_GOLDEN_DIR / f"{key}.jsonl")
    reports = replay_golden(key, golden, device=cuda, backend="fused")
    assert golden.diff(reports) == []
    assert all(r.exact for r in reports)
    counts = ops.launch_counts()
    assert counts["fused_worker"] > 0
    assert counts["decode_partial" if key == "crawler_partial" else "decode"] > 0


def test_batched_bucketed_step_launches_bucket_times(cuda):
    """A batch of 5 pads to the bucket of 8: kernels 1 and 2 launch 8 times
    each, and C equals the CPU reference backend's."""
    from repro_torch.control import AdaptiveServer, ExpectedLatencyPolicy, PlanLadder

    def serve(device, backend):
        lad = PlanLadder(4, 2, 1, K=12, L=257, backend=backend, device=device)
        lad.prewarm((16, 8), (16, 4), batch_sizes=(4, 8))
        srv = AdaptiveServer(lad, policy=ExpectedLatencyPolicy(
            lad, overhead_s={r: 0.0 for r in lad.rungs}),
            feed=lambda s, r: np.r_[np.full(10, 1.0), 2.0, 2.0],
            check_exact=True)
        rng = np.random.default_rng(11)
        A = torch.as_tensor(rng.integers(-4, 5, size=(5, 16, 8)),
                            dtype=torch.float64, device=device)
        B = torch.as_tensor(rng.integers(-4, 5, size=(16, 4)),
                            dtype=torch.float64, device=device)
        srv.run(2, lambda i: (A, B))        # warm the monitor
        ops.reset_launch_counts()
        C, rep = srv.step(A, B)
        torch.cuda.synchronize()
        return C, rep, ops.launch_counts()

    C, rep, counts = serve(cuda, "fused")
    C_ref, rep_ref, _ = serve("cpu", "reference")
    assert counts == dict(_NONE, fused_worker=8, decode=8)
    assert rep.exact and rep.erased == rep_ref.erased == (10, 11)
    assert torch.equal(C.cpu(), C_ref)


# -- the serve tier on the card ----------------------------------------------

@pytest.mark.parametrize("backend", ["fused", "staged"])
def test_golden_serve_trace_on_the_kernels(cuda, backend):
    """The checked-in golden serve trace replays through the kernels with an
    empty diff, every batch exact, and every kept product on the card equal
    to the CPU reference backend's."""
    from repro_torch.serve import ServeTrace, golden_serve_result
    from repro_torch.serve.trace import with_golden_meta

    golden = ServeTrace.load(_GOLDEN_DIR / "serve_heavy_tail.jsonl")
    result = golden_serve_result(device=cuda, backend=backend)
    trace = with_golden_meta(ServeTrace.from_result(result))
    assert trace.diff(golden) == [] and trace.meta == golden.meta
    assert all(b.report["exact"] for b in result.batches)
    counts = ops.launch_counts()
    assert counts["fused_worker" if backend == "fused" else "matmul_t"] > 0
    plain = golden_serve_result(device="cpu").results
    assert set(plain) == set(result.results)
    for rid, C in result.results.items():
        assert C.device.type == "cuda" and torch.equal(C.cpu(), plain[rid])


# -- the mesh backend on the card --------------------------------------------

_MESH_PLAN = dict(kind="bec", p=2, m=2, n=1, K=4, L=256 * 8 * 8 + 1, points="chebyshev")
_MESH_ERASED = ([], [1], [0, 3])


def _mesh_operands():
    rng = np.random.default_rng(0)
    return (torch.as_tensor(rng.integers(0, 9, size=(256, 192)), dtype=torch.float64),
            torch.as_tensor(rng.integers(0, 9, size=(256, 160)), dtype=torch.float64))


def _mesh_rank(mesh):
    """One rank of the 4-rank mesh: its C per erasure set (fused, then one
    staged request and one partial), on the card, copied to the host."""
    A, B = (x.cuda() for x in _mesh_operands())
    cm = CodedMatmul(make_plan(**_MESH_PLAN), "mesh", mesh=mesh)
    out = {tuple(e): cm(A, B, erased=e).cpu() for e in _MESH_ERASED}
    out["staged"] = cm.with_backend("mesh", fused=False)(A, B, erased=[1]).cpu()
    out["partial"] = cm(A, B, progress=np.r_[0.5, 0.5, 1, 1], sub_tasks=2).cpu()
    return out, str(cm.device), cm._executor.transport


def test_mesh_four_ranks_on_one_card(cuda):
    """Four ranks sharing the card (gloo, Y staged through pinned host
    memory): every rank's C exact and bit-identical to the local fused
    facade's, each rank launching its own kernels."""
    from repro_torch.launch.mesh import spawn_mesh

    outs = spawn_mesh(_mesh_rank, data=1, model=4, device="cuda", timeout_s=300)
    A, B = (x.cuda() for x in _mesh_operands())
    local = CodedMatmul(make_plan(**_MESH_PLAN))
    want = {tuple(e): local(A, B, erased=e).cpu() for e in _MESH_ERASED}
    want["staged"] = want[(1,)]
    want["partial"] = local(A, B, progress=np.r_[0.5, 0.5, 1, 1], sub_tasks=2).cpu()
    exact = (A.T @ B).cpu()
    for out in outs:
        Cs, device, transport = out.result
        assert device.startswith("cuda") and transport.endswith("pinned host memory")
        for key, C in Cs.items():
            assert torch.equal(C, exact), key
            assert torch.equal(C.view(torch.int64), want[key].view(torch.int64)), key
        assert out.launches == dict(_NONE, fused_worker=4, decode=4, encode=2,
                                    matmul_t=1, decode_partial=1)


# ---------------------------------------------------------------------------
# shapes past the caps the kernels once had (phase 3c of chip_smoke)


def _ints(gen, shape, lo, hi, dtype=torch.float64):
    return torch.randint(lo, hi + 1, shape, generator=gen).to("cuda", dtype)


@pytest.mark.parametrize("rows", [64, 300])
def test_decode_panels_past_48_kb_decode_bit_for_bit(cuda, rows):
    """The polycode K=100 plan's (64, 100) float64 panel (51,200 bytes) and a
    (300, 100) one past the card's per-block shared memory (227 KB on an
    H100: two row slabs, a launch each), through kernels 2 and 3, integer
    panels and products: bit for bit."""
    gen = torch.Generator().manual_seed(11)
    W, Y = _ints(gen, (rows, 100), -4, 4), _ints(gen, (100, 5000), -1000, 1000)
    assert torch.equal(ops.decode(W, Y, 32.0), ref.decode_ref(W, Y, 32.0))
    Ws = _ints(gen, (3, rows, 100), -4, 4)
    for bounds in ([0, 1024, 2048, 5000], [0, 1023, 2049, 5000]):
        assert torch.equal(ops.decode_partial(Ws, Y, 32.0, bounds=bounds),
                           ref.decode_partial_ref(Ws, Y, 32.0, True, bounds))
    slabs = 1 if rows == 64 else 2
    assert ops.launch_counts() == dict(_NONE, decode=slabs, decode_partial=2 * slabs)


def test_decode_partial_takes_more_than_128_chunks(cuda):
    gen = torch.Generator().manual_seed(12)
    Ws = _ints(gen, (200, 4, 10), -4, 4)
    Y = _ints(gen, (10, 200 * 64 + 3), -1000, 1000)
    E = Y.shape[1]
    for bounds in ([0, *range(64, 200 * 64, 64), E], [0, *range(63, 199 * 64, 64), E]):
        assert torch.equal(ops.decode_partial(Ws, Y, 2.0 ** 20, bounds=bounds),
                           ref.decode_partial_ref(Ws, Y, 2.0 ** 20, True, bounds))
    Ys = _ints(gen, (200, 10, 96), -1000, 1000)
    assert torch.equal(ops.decode_partial(Ws, Ys, 2.0 ** 20),
                       ref.decode_partial_ref(Ws, Ys, 2.0 ** 20, True))
    assert ops.launch_counts() == dict(_NONE, decode_partial=3 * 2)   # groups of 128


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("data", ["random", "integer"])
def test_fused_and_encode_take_more_than_64_blocks(cuda, dtype, data):
    """P = Q = 80 blocks a side (offsets through device memory; bf16 in the
    one-element form), and kernel 4 with a float64 panel past the card's
    shared memory (K = 400: two slabs of workers on an H100, a launch
    each)."""
    gen = torch.Generator().manual_seed(13)
    ca, cb = _data(gen, (6, 80), dtype, data), _data(gen, (6, 80), dtype, data)
    a, b = _data(gen, (8, 10, 64, 96), dtype, data), _data(gen, (10, 8, 64, 80), dtype, data)
    _check(ops.fused_worker(ca, cb, a, b), ref.fused_worker_ref(ca, cb, a, b), data)
    for K in (7, 400):
        c = _data(gen, (K, 80), dtype, data)
        out = ops.encode(c, a)
        _check(out, ref.encode_ref(c, a.reshape(80, -1)).reshape(out.shape), data)
    assert ops.launch_counts() == dict(_NONE, fused_worker=1,
                                       encode=3 if dtype == torch.float64 else 2)


@pytest.mark.parametrize("dk,dv", [(128, 64), (256, 32), (64, 256), (96, 80), (320, 64)])
def test_wkv_takes_any_head_and_value_width(cuda, dk, dv):
    gen = torch.Generator().manual_seed(14)
    w = torch.exp(-torch.exp(torch.randn(2, 100, 3, dk, generator=gen)))
    k, r = (torch.randn(2, 100, 3, dk, generator=gen) for _ in range(2))
    v, u = torch.randn(2, 100, 3, dv, generator=gen), torch.randn(3, dk, generator=gen)
    args = [t.to(cuda) for t in (w, k, v, r, u)]
    for o, e in zip(ops.wkv_scan(*args), ref.wkv_scan_ref(*args)):
        _close(o, e)
    assert ops.launch_counts() == dict(_NONE, wkv_scan=-(-dk // 256))   # rows in groups


@pytest.mark.parametrize("s", [64, 24, 100])
def test_selective_scan_takes_any_state_size(cuda, s):
    gen = torch.Generator().manual_seed(15)
    dt = torch.nn.functional.softplus(torch.randn(2, 150, 100, generator=gen))
    x = torch.randn(2, 150, 100, generator=gen)
    Bm, Cm = (torch.randn(2, 150, s, generator=gen) for _ in range(2))
    A_log, D = torch.rand(100, s, generator=gen) * 0.9 + 0.1, torch.randn(100, generator=gen)
    args = [t.to(cuda) for t in (dt, x, Bm, Cm, A_log, D)]
    for o, e in zip(ops.mamba_scan(*args), ref.mamba_scan_ref(*args)):
        _close(o, e)
    assert ops.launch_counts() == dict(_NONE, mamba_scan=-(-s // 64))   # states in groups


def test_mesh_gather_takes_the_nccl_branch_on_one_rank(cuda, tmp_path, monkeypatch):
    """``MeshExecutor._all_gather``'s NCCL branch on the card: a one-rank
    NCCL group, a (1, 1) mesh and a K = 1 bec plan; the gather goes
    through ``all_gather_into_tensor`` on device tensors and C equals the
    local fused facade's bit for bit (and A^T B)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        assert dist.get_backend(mesh.get_group("model")) == "nccl"
        gathers = []
        real = dist.all_gather_into_tensor

        def spy(out, inp, *args, **kwargs):
            gathers.append((out.device.type, inp.device.type))
            return real(out, inp, *args, **kwargs)

        monkeypatch.setattr(dist, "all_gather_into_tensor", spy)
        v = 256
        plan = make_plan("bec", 1, 1, 1, K=1, L=v * 4 * 4 + 1, points="chebyshev")
        gen = torch.Generator().manual_seed(5)
        A = torch.randint(-4, 5, (v, 128), generator=gen).double().to(cuda)
        B = torch.randint(-4, 5, (v, 96), generator=gen).double().to(cuda)
        C = CodedMatmul(plan, "mesh", mesh=mesh, device=cuda)(A, B)
        C_local = CodedMatmul(plan, "fused", device=cuda)(A, B)
        torch.cuda.synchronize()
        assert gathers == [("cuda", "cuda")]
        assert torch.equal(C, C_local) and torch.equal(C, A.T @ B)
        assert ops.launch_counts()["fused_worker"] == 2 and ops.launch_counts()["decode"] == 2
    finally:
        dist.destroy_process_group()


# -- captured requests: the traced kinds in a CUDA graph ---------------------------

_CAPTURE_ERASED = ([0, 2, 4, 6, 8, 9], [1, 3, 5, 7, 9], [], [2, 3, 4, 5, 6, 7])
_CAPTURE_PROGRESS = ([4, 1, 4, 0, 0, 1, 3, 4, 1, 4], [3, 3, 2, 2, 1, 2, 3, 0, 2, 3],
                     [4, 4, 4, 4, 4, 4, 4, 4, 4, 4])


def _capture_problem():
    gen = torch.Generator().manual_seed(23)
    A = torch.randint(0, 6, (256, 96), generator=gen).to("cuda", torch.float64)
    B = torch.randint(0, 6, (256, 80), generator=gen).to("cuda", torch.float64)
    plan = make_plan("bec", 2, 2, 2, K=10, L=256 * 25 + 1, points="equispaced")
    return A, B, plan


@pytest.mark.parametrize("backend,sub_tasks,per_request", [
    ("fused", 1, dict(fused_worker=1, decode=1)),
    ("staged", 1, dict(encode=2, matmul_t=10, decode=1)),
    ("fused", 4, dict(fused_worker=1, decode_partial=1)),
    ("reference", 1, {}),
], ids=["fused", "staged", "partial", "reference"])
def test_captured_request_replays_under_new_survivor_sets(cuda, backend, sub_tasks,
                                                          per_request):
    """One request captured with a device mask (progress at Q = 4) buffer,
    replayed under survivor sets written into it: every replay equals
    A^T B and the concrete request's C.  The kernels count at the eager
    warm-up and at the capture (twice a request's launches), never at a
    replay."""
    A, B, plan = _capture_problem()
    cm = CodedMatmul(plan, backend, sub_tasks=sub_tasks)
    buf = torch.ones(plan.K, dtype=torch.float64, device="cuda")
    graph, C = cm.capture(A, B, **({"progress": buf} if sub_tasks > 1 else {"mask": buf}))
    assert ops.launch_counts() == dict(_NONE, **{k: 2 * v for k, v in per_request.items()})
    if sub_tasks > 1:
        sets = [np.asarray(c) / sub_tasks for c in _CAPTURE_PROGRESS]
        concrete = [cm(A, B, progress=x) for x in sets]
    else:
        sets = [np.where(np.isin(np.arange(plan.K), e), 0.0, 1.0) for e in _CAPTURE_ERASED]
        concrete = [cm(A, B, mask=x) for x in sets]
    ops.reset_launch_counts()
    for x, want in zip(sets, concrete):
        buf.copy_(torch.as_tensor(x))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(C, A.T @ B) and torch.equal(C, want)
    assert ops.launch_counts() == _NONE


def test_captured_request_replays_through_the_cluster_form(cuda):
    """A fused request whose blocks span two tiles a side (256^2) captured
    with a device mask: kernel 1 takes the cluster form at the warm-up and
    at the capture, and every replay equals A^T B and the concrete C."""
    gen = torch.Generator().manual_seed(29)
    A = torch.randint(0, 6, (512, 512), generator=gen).to("cuda", torch.float64)
    B = torch.randint(0, 6, (512, 520), generator=gen).to("cuda", torch.float64)
    plan = make_plan("bec", 2, 2, 2, K=10, L=512 * 25 + 1, points="equispaced")
    cm = CodedMatmul(plan)
    buf = torch.ones(plan.K, dtype=torch.float64, device="cuda")
    graph, C = cm.capture(A, B, mask=buf)
    assert ops.launch_counts() == dict(_NONE, fused_worker=2, decode=2,
                                       **{ops.CLUSTER_LAUNCHES: 2})
    for erased in _CAPTURE_ERASED:
        x = np.where(np.isin(np.arange(plan.K), erased), 0.0, 1.0)
        want = cm(A, B, mask=x)
        buf.copy_(torch.as_tensor(x))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(C, A.T @ B) and torch.equal(C, want)
    assert ops.launch_counts()[ops.CLUSTER_LAUNCHES] == 2 + len(_CAPTURE_ERASED)


def test_kernel_calls_under_capture_count_traced_without_spans(cuda, obs_off):
    """Obs on: the warm-up's calls count ``traced=0`` with an event-timed
    span each, the captured ones ``traced=1`` with no span and no event
    synchronize (which would break the capture)."""
    A, B, plan = _capture_problem()
    cm = CodedMatmul(plan)
    buf = torch.ones(plan.K, dtype=torch.float64, device="cuda")
    obs.enable(fresh=True)
    graph, C = cm.capture(A, B, mask=buf)
    reg, rec = obs.session().registry, obs.session().recorder
    for op in ("fused_worker", "decode"):
        assert reg.value("kernel.call", op=op, traced=1) == 1, op
        assert reg.value("kernel.call", op=op, traced=0) == 1, op
        assert len(rec.by_name(f"kernel.{op}")) == 1, op
    buf[3] = 0
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(C, A.T @ B)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_more_than_64_blocks_capture_with_kept_offsets(cuda, dtype):
    """Kernels 1 and 4 past 64 blocks read their offsets from device memory:
    the eager call keeps them there, so the same calls capture and replay."""
    gen = torch.Generator().manual_seed(24)
    ca, cb = _data(gen, (6, 80), dtype, "integer"), _data(gen, (6, 80), dtype, "integer")
    a, b = _data(gen, (8, 10, 64, 96), dtype, "integer"), _data(gen, (10, 8, 64, 80), dtype,
                                                                "integer")

    def calls():
        return ops.fused_worker(ca, cb, a, b), ops.encode(ca, a)

    eager = calls()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    a.mul_(2)
    graph.replay()
    torch.cuda.synchronize()
    for got, want, first in zip(out, calls(), eager):
        assert torch.equal(got, want) and torch.equal(want, 2 * first)


def test_a_concrete_pattern_is_refused_under_capture(cuda):
    """A host-known survivor set needs its host panel copied in, which a
    capture cannot do: refused before any launch, naming the traced kinds."""
    A, B, plan = _capture_problem()
    cm = CodedMatmul(plan)
    cm(A, B, erased=[1])
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="device tensor"):
        with torch.cuda.graph(graph):
            cm(A, B, erased=[1])
    assert torch.equal(cm(A, B, erased=[2]), A.T @ B)
