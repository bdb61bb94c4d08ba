"""The paper's experiments on the port, against the JAX package's benches.

Holds the three twins - ``benchmarks/torch_table1_error.py``,
``torch_fig1_latency.py`` and ``torch_tradeoff_sweep.py`` - against
``benchmarks/table1_error.py``, ``fig1_latency.py`` and
``tradeoff_sweep.py`` at v <= 256 on the CPU, plus the deprecated
``core.api`` shims and the ``paper_matmul`` config they read.

Table I tolerance.  Where the decode is exact, ``rel_err`` is 0.0 in both
packages and must be 0.0 in both.  Where it is not, the error is the
float64 rounding residue of the interpolation (entries whose error crosses
1/2 wrap mod s), and which entries wrap depends on the last bits of each
sum, so it moves with the summation order of the matmuls (XLA's dot vs
torch's einsum on the CPU, DMMA tiles on the card).  Its scale is set by
max|X| against the 53-bit mantissa, which both packages share, so the two
must be nonzero in the same rows and agree within a factor of 2 (observed
at v=256: within 1.28x).
"""
import dataclasses
import inspect
import warnings

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import benchmarks.fig1_latency as jfig1  # noqa: E402
import benchmarks.table1_error as jtable1  # noqa: E402
import benchmarks.torch_fig1_latency as fig1  # noqa: E402
import benchmarks.torch_table1_error as table1  # noqa: E402
import benchmarks.torch_tradeoff_sweep as tradeoff  # noqa: E402
import benchmarks.tradeoff_sweep as jtradeoff  # noqa: E402
import repro.core.api as japi  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import paper_matmul as jpaper  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs import paper_matmul  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core import coded_matmul, make_plan  # noqa: E402
from repro_torch.core.api import runtime_facade  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import CodedMatmul  # noqa: E402

V = 256
FIELDS = ("bound", "L", "s", "log2_maxX", "analytic_safe")


@pytest.fixture(scope="module")
def jax_table1():
    return jtable1.run(v=V)


@pytest.mark.parametrize("fused", [False, True])
def test_table1_rows_match_reference(jax_table1, fused):
    rows = table1.run(v=V, fused=fused, device="cpu")
    assert len(rows) == len(jax_table1) == 8
    for row, jrow in zip(rows, jax_table1):
        assert {k: row[k] for k in FIELDS} == {k: jrow[k] for k in FIELDS}
        assert (row["rel_err"] == 0.0) == (jrow["rel_err"] == 0.0), row
        if jrow["rel_err"] != 0.0:
            assert 0.5 < row["rel_err"] / jrow["rel_err"] < 2.0, (row, jrow)
    # the analytically safe rows are the exact ones, at this size too
    assert [r["rel_err"] == 0.0 for r in rows][:2] == [True, True]
    assert all(r["rel_err"] > 0 for r in rows if not r["analytic_safe"])


def test_table1_fused_and_reference_agree_where_exact():
    a = table1.run(v=128, bounds_list=(15, 100), fused=True, device="cpu")
    b = table1.run(v=128, bounds_list=(15, 100), fused=False, device="cpu")
    assert [r["rel_err"] for r in a] == [r["rel_err"] for r in b] == [0.0, 0.0]


def test_fig1_simulated_rows_equal_reference_simulator():
    """Fed the same worker and decode times, the port's rows are JAX's
    ``simulate_completion`` with the reference bench's seeds and trials."""
    tw, td = 0.0123, 0.00042
    rows = fig1.run(size=64, trials=20, device="cpu", t_worker=tw,
                    t_decode=td)
    assert [(r["scheme"], r["stragglers"]) for r in rows] == \
        [(s, S) for s in ("bec", "polycode") for S in range(9)]
    cfg = jpaper.SMOKE
    for r in rows:
        jmodel = jsim.LatencyModel(base=tw,
                                   straggler_slowdown=cfg.straggler_slowdown)
        lat = jsim.simulate_completion(cfg.K, r["tau"], r["stragglers"],
                                       jmodel, decode_time=td, trials=20,
                                       seed=r["stragglers"])
        assert r["latency_s"] == float(np.mean(lat))
        assert (r["worker_s"], r["decode_s"]) == (tw, td)
        assert r["worker_library_s"] > 0 and r["decode_measured_s"] > 0
    taus = {r["scheme"]: r["tau"] for r in rows}
    assert taus == {"bec": 4, "polycode": 9}
    # the paper's shape: bec flat through S=6 and up at S=7; polycode up
    # from S=2
    bec = [r["latency_s"] for r in rows if r["scheme"] == "bec"]
    poly = [r["latency_s"] for r in rows if r["scheme"] == "polycode"]
    assert len(set(bec[:7])) == 1 and bec[7] > bec[6]
    assert poly[2] > poly[0]


def test_fig1_errors_match_reference():
    """Measured times differ between the packages; the decoded products do
    not: both schemes' rel_err equals the reference bench's at size 64."""
    jrows = jfig1.run(size=64, trials=2)
    rows = fig1.run(size=64, trials=2, device="cpu")
    jerr = {r["scheme"]: r["rel_err"] for r in jrows}
    err = {r["scheme"]: r["rel_err"] for r in rows}
    assert err == jerr


def test_tradeoff_rows_equal_reference():
    rows = tradeoff.run(device="cpu")
    assert rows == jtradeoff.run()
    assert [r["p_prime"] for r in rows] == [1, 2, 4, 8]
    wide = tradeoff.run(v=64, cols=48, device="cpu")
    assert [r["tau"] for r in wide] == [r["tau"] for r in rows]


def test_paper_benches_refuse_to_guess_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (table1.run, fig1.run, tradeoff.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


# -- the paper_matmul config --------------------------------------------------

def test_paper_config_equals_reference():
    for ours, theirs in ((paper_matmul.CONFIG, jpaper.CONFIG),
                         (paper_matmul.SMOKE, jpaper.SMOKE)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.L == theirs.L
    assert get_config("paper_matmul") == paper_matmul.CONFIG
    assert dataclasses.asdict(get_config("paper_matmul")) == \
        dataclasses.asdict(jget_config("paper_matmul"))
    assert "paper_matmul" not in list_archs()
    assert set(list_archs()) == {"jamba_1_5_large_398b", "rwkv6_3b", "qwen3_0_6b",
                                 "qwen2_0_5b", "granite_3_8b", "gemma3_12b",
                                 "qwen2_moe_a2_7b", "qwen3_moe_235b_a22b",
                                 "musicgen_medium", "qwen2_vl_72b"}


# -- the deprecated shims -----------------------------------------------------

def _problem(seed=0):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.integers(0, 6, size=(32, 12)), dtype=torch.float64)
    B = torch.as_tensor(rng.integers(0, 6, size=(32, 10)), dtype=torch.float64)
    return A, B, dict(K=10, L=32 * 25 + 1, points="equispaced")


@pytest.mark.parametrize("fused", [False, True])
def test_coded_matmul_warns_and_equals_facade(fused):
    A, B, kw = _problem()
    plan = make_plan("bec", 2, 2, 2, **kw)
    with pytest.warns(DeprecationWarning, match="CodedMatmul"):
        C = coded_matmul(A, B, plan, erased=[1, 4], fused=fused,
                         device="cpu")
    backend = "fused" if fused else "reference"
    expect = CodedMatmul(plan, backend, device="cpu")(A, B, erased=[1, 4])
    assert torch.equal(C, expect) and torch.equal(C, A.T @ B)
    assert runtime_facade(plan, backend, device="cpu").backend == backend
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        C2 = coded_matmul(A, B, plan, survivors=[0, 2, 5, 9], fused=fused,
                          device="cpu")
        assert torch.equal(C2, A.T @ B)
        with pytest.raises(ValueError, match="only one"):
            coded_matmul(A, B, plan, erased=[1], survivors=[0, 2, 5, 9],
                         device="cpu")


def test_runtime_facade_one_per_plan_value():
    _, _, kw = _problem()
    p1, p2 = make_plan("bec", 2, 2, 2, **kw), make_plan("bec", 2, 2, 2, **kw)
    assert p1 is not p2
    cm = runtime_facade(p1, device="cpu")
    assert runtime_facade(p2, device="cpu") is cm
    assert runtime_facade(p2, "fused", torch.float64, device="cpu") is cm
    assert runtime_facade(p1, "reference", device="cpu") is not cm
    assert runtime_facade(p1, dtype=torch.float32, device="cpu") is not cm
    other = make_plan("bec", 2, 2, 2, K=11, L=kw["L"], points="equispaced")
    assert runtime_facade(other, device="cpu") is not cm
    own = p1.make_panel_cache()
    mine = runtime_facade(p1, panel_cache=own, device="cpu")
    assert mine is not cm and mine.panel_cache is own
    assert runtime_facade(p1, panel_cache=own, device="cpu") is mine


def test_runtime_facade_memo_is_fifo_bounded():
    _, _, kw = _problem()
    first = make_plan("bec", 2, 2, 2, **kw)
    cm = runtime_facade(first, device="cpu")
    for K in range(11, 11 + api._RUNTIME_FACADES_MAX):
        runtime_facade(make_plan("bec", 2, 2, 2, K=K, L=kw["L"]), device="cpu")
    assert len(api._RUNTIME_FACADES) <= api._RUNTIME_FACADES_MAX
    assert runtime_facade(first, device="cpu") is not cm


def test_shim_counts_no_launch_on_the_cpu():
    A, B, kw = _problem(1)
    ops.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        coded_matmul(A, B, make_plan("bec", 2, 2, 2, **kw), fused=True,
                     device="cpu")
    assert all(n == 0 for n in ops.launch_counts().values())


def test_api_function_lists_differ_only_by_plan_from_arrays():
    def public(mod):
        return {name for name, obj in vars(mod).items()
                if inspect.isfunction(obj) and obj.__module__ == mod.__name__
                and not name.startswith("_")}

    assert public(api) - public(japi) == {"plan_from_arrays"}
    assert public(japi) - public(api) == set()
