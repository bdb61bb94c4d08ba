"""The check that decides ``correct``: sound runs pass it, the control (the
program's float32 path) and every fault a cell can have fail it.

Runs skip the harness's look for a card and drive the rest of a run on the
program's plain CPU path, at the configurations' inner dimension v = 8000
and 32 x 32 outputs, so the entries' sums are as large as on the card.
"""
import numpy as np
import pytest
import torch

from coded_bench import run, spec

coded = spec.module("problems", "coded_matmul")

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SMALL = {"r": 32, "t": 32}


def _run(cell, seed=2**31 + 9, **kw):
    torch.set_num_threads(2)
    return run.run_cell(cell, seed, 0.15, False, device="cpu", overrides=SMALL, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_abs_err"]["value"] == 0.0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics(
        spec.benchmark(), cell, "end_to_end")}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_float32_is_not_correct(cell):
    res = _run(cell, control="float32")
    assert not res["correct"]
    assert res["checks"]["max_abs_err"]["value"] >= 1.0


def _stale(monkeypatch):
    from repro_torch.runtime import CodedMatmul

    inner, last = CodedMatmul.__call__, {}

    def call(self, A, B, *a, **kw):
        C = inner(self, A, B, *a, **kw)
        prev, last["C"] = last.get("C"), C
        return C if prev is None else prev

    monkeypatch.setattr(CodedMatmul, "__call__", call)


def _half_left_out(monkeypatch):
    from repro_torch.runtime import CodedMatmul

    inner = CodedMatmul.__call__

    def call(self, A, B, *a, **kw):
        C = inner(self, A, B, *a, **kw).clone()
        C[C.shape[0] // 2:] = 0
        return C

    monkeypatch.setattr(CodedMatmul, "__call__", call)


def _altered_product(monkeypatch):
    from repro_torch.runtime import executors

    inner = executors.FusedKernelExecutor.worker_products

    def products(self, plan, a_blocks, b_blocks, tables=None):
        Y = inner(self, plan, a_blocks, b_blocks, tables)
        Y[:, 0, 0] = 2 * Y[:, 0, 0] + 1     # every worker's first entry wrong
        return Y

    monkeypatch.setattr(executors.FusedKernelExecutor, "worker_products", products)


@pytest.mark.parametrize("fault", [_stale, _half_left_out, _altered_product])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], (fault.__name__, res["checks"])


def test_traced_run_reads_its_layers():
    torch.set_num_threads(2)
    res = run.run_cell("tradeoff-8000-adaptive", 3, 0.4, True, device="cpu",
                       overrides=SMALL)
    assert res["correct"]
    assert set(res["metrics"]) == {"panel_builds_per_step", "begin_step_ms"}
    assert res["metrics"]["begin_step_ms"]["value"] > 0
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    # no device work on the CPU: the whole traced window is idle, and the
    # host ranges the entry marks name part of it
    gaps = dict(res["breakdown"]["idle_gaps"])
    assert 0 < sum(gaps.values()) <= res["device"]["window_s"] * (1 + 1e-9)
    assert "control.begin_step" in gaps


def test_sample_keeps_the_worst_gain_and_a_uniform_reservoir():
    z = np.linspace(-1, 1, 10)
    sample = coded.Sample(5, z, (4,))
    spread, bunched = [(1, 1, 0, 0, 0, 1, 0, 0, 0, 1)], [(0, 0, 0, 0, 0, 0, 1, 1, 1, 1)]
    for i in range(100):
        sample.offer(i, i % 4, f"C{i}", 4, bunched if i == 37 else spread)
    kept = [i for i, _, _ in sample.items()]
    assert 37 in kept and len(kept) <= coded.KEEP + 1
    assert sample.worst[0] == pytest.approx(243.0, rel=1e-6)


def test_adaptive_serves_the_feasible_rung(monkeypatch):
    """At the paper's bound only the tau = 9 rung decodes exactly: every
    served step is decoded from 9 or more workers."""
    torch.set_num_threads(2)
    seen = []
    inner = coded.Problem.keep

    def keep(self, req, answer, served):
        seen.append(served[0])
        inner(self, req, answer, served)

    monkeypatch.setattr(coded.Problem, "keep", keep)
    res = run.run_cell("tradeoff-8000-adaptive", 21, 0.3, False, device="cpu",
                       overrides=SMALL)
    assert res["correct"] and seen and set(seen) == {9}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    """The float32 control at the cell's own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (11, 12, 13):
        assert not run.run_cell(cell, seed, 2.0, False, control="float32")["correct"]
