"""The work accounting, pinned at the paper's 8000^2 geometry."""
import pytest

from coded_bench import accounting, peaks, spec


@pytest.fixture(params=["as configured", "bec"])
def cfg(request):
    # the counts follow the shapes alone: the optimal-threshold scheme at
    # the same geometry counts the same work
    cfg = spec.config(spec.benchmark(), "paper-tradeoff-8000-e50")
    return cfg if request.param == "as configured" else dict(cfg, scheme="bec")


def test_worker_stage_counts(cfg):
    assert accounting.worker_stage_flops(cfg) == pytest.approx(1.28256e12, rel=1e-12)
    assert accounting.worker_stage_bytes(cfg) == 2.304e9


def test_decode_counts(cfg):
    assert accounting.decode_bytes(cfg) == 1.792e9
    assert accounting.decode_flops(cfg) == 1.28e9


def test_request_counts_every_worker(cfg):
    # tau does not enter: all K products are computed before anyone straggles
    assert accounting.request_flops(cfg) == pytest.approx(1.28384e12, rel=1e-12)


def test_bounds(cfg):
    worker = accounting.bound_s(accounting.worker_stage_flops(cfg),
                                accounting.worker_stage_bytes(cfg))
    assert worker == pytest.approx(19.143e-3, rel=1e-3)          # FLOP-bound
    assert worker == accounting.worker_stage_flops(cfg) / peaks.FP64_TENSOR_FLOPS
    decode = accounting.bound_s(accounting.decode_flops(cfg), accounting.decode_bytes(cfg))
    assert decode == pytest.approx(0.5349e-3, rel=1e-3)          # bytes-bound
    assert decode == accounting.decode_bytes(cfg) / peaks.HBM_BYTES_PER_S


def test_uneven_blocks_pad_up():
    cfg = dict(v=5, r=3, t=7, p=2, m=2, n=2, K=3)
    assert accounting.blocks(cfg) == (3, 2, 4)
