"""The port's op-level accounting (``launch/hlo_analysis.py``): the twin of
``tests/test_integration.py::TestHloAnalysis``, and its own rules.

The reference test parses an HLO module: a dot, an all-reduce over groups
of 2 and an all-gather over groups of 4 inside a while loop of 7.  Here the
same program runs in PyTorch on a fake (2, 2) mesh (a fake process group
of 4 ranks, this process rank 0) under ``OpAccounting``, and the same byte
and FLOP values come out.  The loop runs 7 times, so the all-gather
counts 7 calls where the reference counts 1 instruction.
"""
import io
import json

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.kernels import ops
from repro_torch.launch.hlo_analysis import OpAccounting, analyze, analyze_records
from test_integration import TestHloAnalysis as JaxHlo


@pytest.fixture(scope="module")
def mesh():
    """A (2, 2) ("data", "model") mesh of a fake 4-rank group, rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _program(mesh):
    """The reference HLO's program: a dot, its all-reduce over the groups
    of 2 ({0,1},{2,3}: the "model" dimension), and an all-gather over all 4
    ranks in a loop of 7 (f32[2,64] per rank -> f32[8,64])."""
    def prog(a, b, x):
        d = a @ b
        ar = funcol.all_reduce(d, "sum", (mesh, 1))
        for _ in range(7):
            x = funcol.all_gather_tensor(x[:2], 0, dist.group.WORLD)
        return ar, x
    return prog


def _inputs():
    return torch.ones(8, 16), torch.ones(16, 32), torch.ones(8, 64)


class TestHloAnalysis:
    def test_collective_bytes_match_the_reference(self, mesh):
        _, s = analyze(_program(mesh), *_inputs())
        ref = analyze_hlo(JaxHlo.HLO)
        # all-gather in the loop x7: 8*64*4 bytes * (4-1)/4 * 7
        assert s.bytes_by_kind["all-gather"] == pytest.approx(8 * 64 * 4 * 0.75 * 7)
        # all-reduce: 8*32*4 * 2*(2-1)/2
        assert s.bytes_by_kind["all-reduce"] == pytest.approx(8 * 32 * 4 * 1.0)
        assert s.bytes_by_kind == pytest.approx(ref.bytes_by_kind)
        assert s.total_bytes == pytest.approx(ref.total_bytes)

    def test_dot_flops_match_the_reference(self, mesh):
        _, s = analyze(_program(mesh), *_inputs())
        assert s.dot_flops == pytest.approx(2 * 8 * 32 * 16)
        assert s.dot_flops == analyze_hlo(JaxHlo.HLO).dot_flops
        assert s.dot_count == 1

    def test_counts_are_calls(self, mesh):
        """The loop of 7 dispatches 7 all-gathers (the reference's
        instruction count is 1)."""
        _, s = analyze(_program(mesh), *_inputs())
        assert s.count_by_kind == {"all-gather": 7, "all-reduce": 1}
        assert analyze_hlo(JaxHlo.HLO).count_by_kind == {"all-gather": 1, "all-reduce": 1}

    def test_classic_collectives(self, mesh):
        """The classic ``torch.distributed`` collectives (the EP path's) at
        the reference's ring factors: the gathered size for an all-gather,
        the scattered size times G - 1 for a reduce-scatter."""
        x = torch.ones(4, 8)                     # 128 bytes
        group = dist.group.WORLD                 # G = 4

        def prog():
            dist.all_reduce(x, group=group)
            out = torch.empty(16, 8)
            dist.all_gather_into_tensor(out, x, group=group)
            rs = torch.empty(1, 8)
            dist.reduce_scatter_tensor(rs, x, group=group)
            a2a = torch.empty(4, 8)
            dist.all_to_all_single(a2a, x, group=group)

        _, s = analyze(prog)
        assert s.bytes_by_kind == pytest.approx({
            "all-reduce": 128 * 2 * 3 / 4, "all-gather": 512 * 3 / 4,
            "reduce-scatter": 32 * 3, "all-to-all": 128 * 3 / 4})
        assert s.count_by_kind == dict.fromkeys(s.bytes_by_kind, 1)

    def test_dtensor_ops_count_the_local_shard(self, mesh):
        """A DTensor product counts rank 0's local product: rows split over
        "data" (2), so (4, 16) @ (16, 32)."""
        a = distribute_tensor(torch.ones(8, 16), mesh, (Shard(0), Replicate()))
        b = distribute_tensor(torch.ones(16, 32), mesh, (Replicate(), Replicate()))
        out, s = analyze(torch.matmul, a, b)
        assert isinstance(out, DTensor)
        assert s.dot_flops == 2 * 4 * 32 * 16 and s.dot_count == 1


def test_kernel_op_counts_operands_and_results_only():
    """A hand-written kernel op (the WKV scan's custom op) counts the bytes
    of its operands and results, no dots, and one call; its plain body is
    not dispatched to the mode."""
    g = torch.Generator().manual_seed(0)
    B, S, H, dk, dv = 2, 16, 3, 8, 5
    w = torch.rand(B, S, H, dk, generator=g)
    k, r = torch.randn(B, S, H, dk, generator=g), torch.randn(B, S, H, dk, generator=g)
    v, u = torch.randn(B, S, H, dv, generator=g), torch.randn(H, dk, generator=g)
    (y, s_fin, s_bounds), s = analyze(ops.wkv_scan, w, k, v, r, u, chunk=4)
    operands = sum(t.nbytes for t in (w, k, v, r, u))
    results = sum(t.nbytes for t in (y, s_fin, s_bounds))
    assert s.kernel_calls == {"wkv_scan": 1}
    assert s.dot_flops == 0 and s.dot_count == 0
    assert s.hbm_bytes == operands + results


def test_kernel_op_traces_on_cuda_fake_tensors_without_a_launch():
    """Kernels 7 and 6 are custom ops with fake implementations: on CUDA
    fake tensors they give their outputs' shapes and launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ops.reset_launch_counts()
    with FakeTensorMode():
        args = [torch.empty(2, 16, 3, 8, device="cuda") for _ in range(2)]
        v = torch.empty(2, 16, 3, 5, device="cuda")
        y, s_fin, s_bounds = ops.wkv_scan(*args, v, torch.empty(2, 16, 3, 8, device="cuda"),
                                          torch.empty(3, 8, device="cuda"), chunk=4)
        dt, x = (torch.empty(2, 16, 6, device="cuda") for _ in range(2))
        Bm, Cm = (torch.empty(2, 16, 4, device="cuda") for _ in range(2))
        ym, h_fin, h_bounds = ops.mamba_scan(dt, x, Bm, Cm, torch.empty(6, 4, device="cuda"),
                                             torch.empty(6, device="cuda"), chunk=8)
    assert [t.device.type for t in (y, ym)] == ["cuda", "cuda"]
    assert [tuple(t.shape) for t in (y, s_fin, s_bounds)] == [(2, 16, 3, 5), (2, 3, 8, 5),
                                                              (2, 4, 3, 8, 5)]
    assert [tuple(t.shape) for t in (ym, h_fin, h_bounds)] == [(2, 16, 6), (2, 6, 4),
                                                               (2, 2, 6, 4)]
    assert not any(ops.launch_counts().values())


def test_views_move_nothing_and_slice_writes_count_the_update_twice():
    x = torch.zeros(16, 8)
    y = torch.ones(2, 8)
    _, s = analyze(lambda: (x.view(8, 16), x.t(), x.detach(), x[3:5]))
    assert s.hbm_bytes == 0
    _, s = analyze(lambda: x[2:4].copy_(y))
    assert s.hbm_bytes == 2 * y.nbytes
    idx = torch.tensor([1, 5])
    _, s = analyze(lambda: x.index_put_((idx,), y))
    assert s.hbm_bytes == 2 * y.nbytes
    _, s = analyze(lambda: x + 1)
    assert s.hbm_bytes == 2 * x.nbytes


def test_inference_mode_products_are_counted():
    """Under ``inference_mode`` a matmul reaches the mode whole; its parts
    are counted, as ``FlopCounterMode`` counts them."""
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with torch.inference_mode():
        _, s = analyze(torch.matmul, a, b)
    assert s.dot_flops == 2 * 4 * 3 * 8 and s.dot_count == 1


def test_live_and_peak_bytes():
    """The peak of the storages allocated inside the block and live
    together; views and in-place results add nothing; freed storages leave."""
    x = torch.ones(256)                     # 1 KiB, an argument: not counted
    with OpAccounting() as mode:
        a = x * 2                           # +1 KiB
        b = a.view(16, 16)                  # a view: nothing
        a.mul_(3)                           # in place: nothing
        c = torch.cat([a, x])               # +2 KiB -> 3 KiB live
        del a, b, c                         # all freed
        d = x + 1                           # +1 KiB
    assert mode.peak_bytes == 3 * 1024
    assert mode.live_bytes == 1024
    del d


def test_op_log_reanalyzes_to_the_same_stats(mesh):
    """The op log (one JSON line an op) gives the same figures again."""
    log = io.StringIO()
    with OpAccounting(log) as mode:
        _program(mesh)(*_inputs())
        torch.einsum("bij,bjk->bik", torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    records = [json.loads(line) for line in log.getvalue().splitlines()]
    assert {r["op"] for r in records} >= {"aten.mm.default", "aten.bmm.default",
                                          "_c10d_functional.all_reduce.default",
                                          "_c10d_functional.all_gather_into_tensor.default"}
    assert analyze_records(records) == mode.stats()
