"""The reduction of a profile to busy time, device operations and idle gaps."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from coded_bench import trace


class Ev:
    def __init__(self, name, dev, start, end, annotation=False, corr=0, linked=0):
        self._v = (name, dev, start, end - start, annotation)
        self._corr = (corr, linked)

    def correlation_id(self):
        return self._corr[0]

    def linked_correlation_id(self):
        return self._corr[1]

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_busy_gaps_and_ops():
    events = [
        Ev(trace.WINDOW, CPU, 1000, 11000),
        Ev("bench.request", GPU, 1000, 11000, annotation=True),   # mirrored range
        Ev("void k1<double>(double const*)", GPU, 500, 3000),     # clipped to 1000
        Ev("void k1<double>(double const*)", GPU, 2500, 4000),    # overlaps: merged
        Ev("Memcpy HtoD (Pageable -> Device)", GPU, 6000, 7000),
        Ev("decode.panel", CPU, 4100, 5900),
        Ev("aten::copy_", CPU, 7100, 10500),
        Ev("cudaMemcpyAsync", CPU, 7200, 10400),
    ]
    out = trace.reduce(_prof(events))
    assert out["window_s"] == pytest.approx(10000e-9)
    assert out["busy_s"] == pytest.approx(4000e-9)          # [1000, 4000] + [6000, 7000]
    assert out["device_ops"][0] == ["k1<double>", pytest.approx(3500e-9)]  # each op whole
    assert dict(out["device_ops"])["Memcpy HtoD (Pageable -> Device)"] == \
        pytest.approx(1000e-9)
    gaps = dict(out["idle_gaps"])
    # [4000, 6000] and [7000, 11000], each stretch to its innermost host range
    assert gaps["decode.panel"] == pytest.approx(1800e-9)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(3200e-9)
    assert gaps["aten::copy_"] == pytest.approx(200e-9)
    assert gaps["host python"] == pytest.approx(800e-9)
    assert sum(gaps.values()) + out["busy_s"] == pytest.approx(out["window_s"])


def test_stages_claim_the_device_work_launched_inside_them():
    # a device operation shares its correlation id with the runtime call
    # that launched it; the host operations' own ids are another sequence
    events = [
        Ev(trace.WINDOW, CPU, 0, 1000),
        Ev(trace.REQUEST, CPU, 10, 480, corr=1),
        Ev("stage.worker", CPU, 20, 60, corr=2),
        Ev("cudaLaunchKernelExC", CPU, 25, 28, corr=1294, linked=2),
        Ev("fused_worker_kernel", GPU, 30, 330, corr=1294, linked=2),
        Ev("aten::mul_", CPU, 70, 80, corr=1295),         # same number, other kind
        Ev("cudaLaunchKernel", CPU, 72, 75, corr=1295, linked=1295),
        Ev("elementwise_kernel", GPU, 330, 350, corr=1295, linked=1295),
        Ev("decode_kernel", GPU, 350, 400, corr=1300),    # its launch is not traced
        Ev(trace.REQUEST, CPU, 500, 990, corr=3),
        Ev("stage.worker", CPU, 510, 560, corr=4),
        Ev("aten::copy_", CPU, 520, 530, corr=5),
        Ev("cudaMemcpyAsync", CPU, 522, 526, corr=1301, linked=5),
        Ev("Memcpy DtoD", GPU, 540, 600, corr=1301, linked=5),
        Ev("cuLaunchKernel", CPU, 550, 555, corr=1302, linked=4),
        Ev("fused_worker_kernel", GPU, 600, 900, corr=1302, linked=4),
    ]
    out = trace.reduce(_prof(events))
    assert out["requests"] == 2
    assert out["stages"] == {"stage.worker": pytest.approx(660e-9)}
    assert out["device_s"] == pytest.approx(730e-9)


def test_the_tracer_holds_whole_requests_of_the_middle_fifth():
    import torch

    tr = trace.Tracer(True, torch.device("cpu"), 10.0)
    for elapsed in (0.0, 3.9):
        tr.between(elapsed)
        assert tr.prof is None
    for elapsed in (4.0, 5.0):
        tr.between(elapsed)
        with tr.request():
            torch.ones(4).add_(1)
    tr.between(6.1)
    assert tr.prof is None and tr.result["requests"] == 2
    tr.between(7.0)
    assert tr.finished and tr.prof is None


def test_a_profile_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce(_prof([Ev("k", GPU, 0, 10)]))


def test_span_method_wraps_and_returns():
    obj = SimpleNamespace(get=lambda x: x + 1)
    trace.span_method(obj, "get", "decode.panel")
    assert obj.get(1) == 2 and hasattr(obj.get, "__wrapped__")
