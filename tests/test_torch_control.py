"""The port's adaptive control plane (``repro_torch.control``) on the CPU.

Mirrors ``tests/test_control.py`` case for case on ``device="cpu"`` (the
plain PyTorch versions), then holds the port against the JAX package:
the same feed from the same seed through the reference's
``AdaptiveServer`` and the port's must give equal ``StepReport``s (every
field but ``wall_ms``, floats bit for bit) and equal products; the
ladder's float64/float32 feasibility must be the reference's; and the
bench twin (``benchmarks/torch_control_bench.py``) must reproduce a row of
``benchmarks/control_bench.py`` field for field and pass its feedback gate.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.control import (  # noqa: E402
    AdaptiveServer,
    ExpectedLatencyPolicy,
    FeedbackConfig,
    PlanLadder,
    QuantileLatencyPolicy,
    WorkerHealthMonitor,
)
from repro_torch.core import make_plan  # noqa: E402
from repro_torch.core.simulator import LatencyModel  # noqa: E402
from repro_torch.runtime import CacheGroup, CodedMatmul, plan_token  # noqa: E402

K = 12
GRID = (4, 2, 1)  # p, m, n -> rungs bec(tau=2), tradeoff p'=2 (5), polycode(11)
L_ALL_FEASIBLE = 257
L_BEC_INFEASIBLE = 1 << 14
SHAPES = ((16, 8), (16, 4))  # (v, r), (v, t)
CPU = "cpu"


@pytest.fixture(autouse=True)
def _obs_off():
    """The bench's CompileWatch turns obs on; leave it off for the next test."""
    yield
    obs.disable()


def _ladder(L=L_ALL_FEASIBLE, **kw):
    return PlanLadder(*GRID, K=K, L=L, backend="reference", device=CPU, **kw)


def _steady_times(slow=(), base=1.0, slowdown=2.0):
    t = np.full(K, base)
    t[list(slow)] *= slowdown
    return t


def _ints(rng, shape):
    return torch.as_tensor(rng.integers(-4, 5, size=shape), dtype=torch.float64)


def _zeros():
    return (torch.zeros(SHAPES[0], dtype=torch.float64),
            torch.zeros(SHAPES[1], dtype=torch.float64))


def _oracle(A, B):
    return torch.einsum("...vr,...vt->...rt", A, B)


class TestMonitor:
    def test_ewma_tracks_means(self):
        mon = WorkerHealthMonitor(K, alpha=0.5)
        for _ in range(30):
            mon.record_step(_steady_times(slow=[3]))
        np.testing.assert_allclose(mon.mean, _steady_times(slow=[3]))
        assert mon.std.max() < 1e-6

    def test_scores_rise_and_decay(self):
        mon = WorkerHealthMonitor(K, score_decay=0.5)
        for _ in range(4):
            mon.record_step(_steady_times(slow=[7]))
        assert mon.straggler_scores()[7] > 0.9
        assert list(mon.stragglers()) == [7]
        for _ in range(4):
            mon.record_step(_steady_times())  # worker 7 recovers
        assert mon.straggler_scores()[7] < 0.1
        assert mon.stragglers().size == 0

    def test_erasure_mask_respects_budget_and_history(self):
        mon = WorkerHealthMonitor(K, min_history=2)
        mon.record_step(_steady_times(slow=[0, 1, 2]))
        np.testing.assert_array_equal(mon.erasure_mask(K), np.ones(K))
        for _ in range(3):
            mon.record_step(_steady_times(slow=[0, 1, 2]))
        mask = mon.erasure_mask(budget=2)
        assert mask.sum() == K - 2
        assert set(np.flatnonzero(mask == 0)) <= {0, 1, 2}
        full = mon.erasure_mask(budget=6)
        assert set(np.flatnonzero(full == 0)) == {0, 1, 2}

    def test_majority_stragglers_still_flagged(self):
        mon = WorkerHealthMonitor(K)
        slow = list(range(7))
        for _ in range(3):
            mon.record_step(_steady_times(slow=slow))
        assert set(mon.stragglers()) == set(slow)

    def test_fitted_model_per_worker(self):
        mon = WorkerHealthMonitor(K)
        for _ in range(10):
            mon.record_step(_steady_times(slow=[4], slowdown=3.0))
        model = mon.fitted_model()
        base = model.base_vector(K)
        assert base[4] == pytest.approx(3.0, rel=1e-3)
        assert base[0] == pytest.approx(1.0, rel=1e-3)
        assert model.straggler_slowdown == 1.0
        assert model.sample(K, (), np.random.default_rng(0)).shape == (K,)

    def test_fitted_model_survives_transient_spike(self):
        mon = WorkerHealthMonitor(K, alpha=0.3)
        for _ in range(5):
            mon.record_step(_steady_times())
        spike = _steady_times()
        spike[3] = 20.0
        mon.record_step(spike)
        assert mon.std[3] > mon.mean[3]
        model = mon.fitted_model()
        fitted_mean = model.base_vector(K) + \
            model.jitter_vector(K) * model.base_vector(K)
        assert fitted_mean[3] == pytest.approx(mon.mean[3], rel=1e-6)
        assert np.all(model.base_vector(K) > 0)

    @pytest.mark.parametrize("bad", [
        lambda mon: mon.record_step(np.ones(K - 1)),
        lambda mon: mon.record_step(np.full(K, np.nan)),
        lambda mon: mon.erasure_mask(budget=-1),
        lambda mon: WorkerHealthMonitor(K, alpha=0.0),
    ], ids=["shape", "nan", "budget", "alpha"])
    def test_input_validation(self, bad):
        with pytest.raises(ValueError):
            bad(WorkerHealthMonitor(K))


class TestLadder:
    def test_rungs_ascend_in_tau(self):
        lad = _ladder()
        assert lad.rungs == ("bec", "tradeoff(p'=2)", "polycode")
        taus = [lad.tau(r) for r in lad.rungs]
        assert taus == sorted(taus) == [2, 5, 11]
        assert [lad.budget(r) for r in lad.rungs] == [10, 7, 1]

    def test_rungs_beyond_K_dropped(self):
        lad = PlanLadder(4, 2, 1, K=6, L=L_ALL_FEASIBLE, backend="reference",
                         device=CPU)
        assert lad.rungs == ("bec", "tradeoff(p'=2)")

    def test_initial_rung_respects_entry_bound(self):
        assert _ladder().active == "bec"
        lad = _ladder(L=L_BEC_INFEASIBLE)
        assert not lad.feasible("bec")
        assert lad.active == "tradeoff(p'=2)"

    def test_every_rung_exact(self):
        lad = _ladder()
        rng = np.random.default_rng(0)
        A, B = _ints(rng, SHAPES[0]), _ints(rng, SHAPES[1])
        for rung in lad.rungs:
            lad.switch(rung)
            C = lad(A, B, erased=list(range(lad.budget(rung))))
            assert torch.equal(C, A.T @ B)

    def test_prewarm_makes_switch_recompile_free(self):
        lad = _ladder()
        info = lad.prewarm(*SHAPES)
        assert info["builds"] == len(lad.rungs)
        assert set(info["overhead_s"]) == set(lad.rungs)
        builds = lad.cache_info()["builds"]
        A, B = _zeros()
        for step in range(6):
            rung = lad.rungs[step % len(lad.rungs)]
            lad.switch(rung)
            lad(A, B, erased=[step % (lad.budget(rung) + 1)])
        info = lad.cache_info()
        assert info["builds"] == builds, "rung switch rebuilt a pipeline"
        assert info["switches"] >= 5

    def test_unknown_rung_raises(self):
        with pytest.raises(KeyError):
            _ladder().switch("raptor")

    def test_device_default_is_the_card(self, monkeypatch):
        """No device given and no card: the ladder refuses, never the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PlanLadder(*GRID, K=K, L=L_ALL_FEASIBLE)

    def test_split_stages_compose_to_the_call(self):
        lad = _ladder()
        lad.prewarm(*SHAPES, batch_sizes=(4,), stages=True)
        rng = np.random.default_rng(7)
        A, B = _ints(rng, (3,) + SHAPES[0]), _ints(rng, SHAPES[1])
        Y, ctx = lad.worker_stage(A, B)
        assert ctx == {"rung": "bec", "rt": (8, 4), "batch": 3}
        lad.switch("polycode")  # decodes on the rung that produced Y
        C = lad.decode_stage(Y, ctx, erased=[1])
        assert torch.equal(C, _oracle(A, B))


class TestCacheGroup:
    def test_plans_do_not_alias_executables(self):
        group = CacheGroup()
        p1 = make_plan("bec", 4, 2, 1, K=K, L=L_ALL_FEASIBLE,
                       points="chebyshev")
        p2 = make_plan("polycode", 4, 2, 1, K=K, L=L_ALL_FEASIBLE,
                       points="chebyshev")
        cm1 = CodedMatmul(p1, "reference", device=CPU, cache_group=group)
        cm2 = CodedMatmul(p2, "reference", device=CPU, cache_group=group)
        rng = np.random.default_rng(1)
        A, B = _ints(rng, SHAPES[0]), _ints(rng, SHAPES[1])
        assert torch.equal(cm1(A, B, erased=[0]), A.T @ B)
        assert torch.equal(cm2(A, B, erased=[0]), A.T @ B)
        assert group.stats["builds"] == 2
        assert plan_token(p1) != plan_token(p2)

    def test_equal_plans_share_everything(self):
        group = CacheGroup()
        mk = lambda: make_plan("bec", 2, 2, 1, K=4, L=257)  # noqa: E731
        cm1 = CodedMatmul(mk(), "reference", device=CPU, cache_group=group)
        cm2 = CodedMatmul(mk(), "reference", device=CPU, cache_group=group)
        assert cm1.panel_cache is cm2.panel_cache
        A = torch.ones((8, 4), dtype=torch.float64)
        cm1(A, A, erased=[0])
        cm2(A, A, erased=[0])
        assert group.stats["builds"] == 1 and group.stats["hits"] == 1

    def test_group_and_shared_are_exclusive(self):
        plan = make_plan("bec", 2, 2, 1, K=4, L=257)
        cm = CodedMatmul(plan, "reference", device=CPU)
        with pytest.raises(ValueError):
            CodedMatmul(plan, "reference", device=CPU, cache_group=CacheGroup(),
                        _shared=(cm.panel_cache, {}, {"builds": 0, "hits": 0}))


class TestPolicy:
    def _fitted(self, slow=(), slowdown=2.0):
        mon = WorkerHealthMonitor(K)
        for _ in range(5):
            mon.record_step(_steady_times(slow=slow, slowdown=slowdown))
        return mon.fitted_model(), mon.straggler_scores()

    def test_zero_stragglers_prefers_lowest_tau(self):
        lad = _ladder()
        pol = ExpectedLatencyPolicy(lad, overhead_s={r: 0.0 for r in lad.rungs})
        assert pol.select(*self._fitted()).rung == "bec"

    def test_expected_latency_reflects_masking_budget(self):
        lad = _ladder()
        pol = ExpectedLatencyPolicy(lad, overhead_s={r: 0.0 for r in lad.rungs})
        model, scores = self._fitted(slow=[0, 1, 2])
        est = {e.rung: e for e in pol.rank(model, scores)}
        assert est["bec"].expected_latency_s == pytest.approx(1.0)
        assert est["tradeoff(p'=2)"].expected_latency_s == pytest.approx(1.0)
        assert est["polycode"].expected_latency_s == pytest.approx(2.0)
        assert est["polycode"].unmasked_stragglers == 2
        assert pol.select(model, scores).rung == "bec"

    def test_entry_bound_gates_bec(self):
        lad = _ladder(L=L_BEC_INFEASIBLE)
        pol = ExpectedLatencyPolicy(lad, overhead_s={r: 0.0 for r in lad.rungs})
        est = pol.select(*self._fitted(slow=[3]))
        assert est.rung == "tradeoff(p'=2)" and est.feasible
        assert not pol.feasible("bec")

    def test_overhead_breaks_ties(self):
        lad = _ladder()
        pol = ExpectedLatencyPolicy(
            lad, overhead_s={"bec": 0.5, "tradeoff(p'=2)": 0.0,
                             "polycode": 0.0})
        assert pol.select(*self._fitted()).rung == "tradeoff(p'=2)"

    def test_no_feasible_rung_raises(self):
        lad = _ladder(L=1 << 40, include=["bec"])
        with pytest.raises(ValueError, match="decodes exactly"):
            ExpectedLatencyPolicy(lad).select(*self._fitted())


class TestAdaptiveServer:
    def _request(self, seed=0):
        rng = np.random.default_rng(seed)
        return _ints(rng, SHAPES[0]), _ints(rng, SHAPES[1])

    def test_learns_and_masks_persistent_stragglers(self):
        lad = _ladder()
        lad.prewarm(*SHAPES)
        builds = lad.cache_info()["builds"]
        model = LatencyModel(base=1.0, straggler_slowdown=2.0)
        srv = AdaptiveServer(lad, feed=lambda step, rng: model.sample(K, [2, 9], rng),
                             check_exact=True)
        A, B = self._request()
        reports = srv.run(8, lambda i: (A, B))
        assert all(r.exact for r in reports)
        for rep in reports[3:]:
            assert rep.erased == (2, 9)
            assert rep.sim_latency_s == pytest.approx(1.0)
        assert reports[0].sim_latency_s == pytest.approx(2.0)
        assert lad.cache_info()["builds"] == builds

    def test_respecialize_handoff_when_budget_exhausted(self):
        lad = _ladder(include=["polycode"])
        lad.prewarm(*SHAPES)
        model = LatencyModel(base=1.0, straggler_slowdown=2.0)
        srv = AdaptiveServer(lad, feed=lambda s, rng: model.sample(K, [0, 1, 2], rng),
                             check_exact=True)
        A, B = self._request(1)
        late = srv.run(6, lambda i: (A, B))[-1]
        assert late.respecialize
        assert late.shrink_target == (2, 4)
        assert late.slack == 0 and srv.elastic.must_respecialize
        assert late.exact

    def test_switches_rungs_when_entry_bound_changes_ranking(self):
        lad = _ladder(L=L_BEC_INFEASIBLE)
        lad.prewarm(*SHAPES)
        builds = lad.cache_info()["builds"]
        pol = ExpectedLatencyPolicy(lad, overhead_s={r: 0.0 for r in lad.rungs})
        srv = AdaptiveServer(lad, policy=pol,
                             feed=lambda s, r: _steady_times(slow=[5]),
                             check_exact=True)
        A, B = self._request(2)
        reports = srv.run(6, lambda i: (A, B))
        assert {r.rung for r in reports} == {"tradeoff(p'=2)"}
        assert all(r.exact for r in reports)
        assert lad.cache_info()["builds"] == builds

    def test_elastic_policy_consumes_monitor_mask(self):
        lad = _ladder()
        lad.prewarm(*SHAPES)
        srv = AdaptiveServer(lad, feed=lambda s, r: _steady_times(slow=[4]))
        A, B = self._request(3)
        srv.run(4, lambda i: (A, B))
        assert not srv.elastic.healthy[4]
        assert srv.elastic.slack == K - 1 - lad.tau(lad.active)

    def test_feed_shape_validated(self):
        srv = AdaptiveServer(_ladder(), feed=lambda s, r: np.ones(3))
        with pytest.raises(ValueError):
            srv.step(*self._request())

    def test_exactness_check_catches_a_wrong_product(self):
        """The device-side oracle is a real gate: a corrupted C is inexact."""
        srv = AdaptiveServer(_ladder(), feed=lambda s, r: _steady_times(),
                             check_exact=True)
        A, B = self._request(4)
        decision = srv.begin_step()
        C = srv.execute(decision, A, B)
        assert srv.complete_step(decision, C, 0.0, A, B).exact
        decision = srv.begin_step()
        C = srv.execute(decision, A, B).clone()
        C[0, 0] += 1.0
        assert srv.complete_step(decision, C, 0.0, A, B).exact is False


class TestQuantilePolicy:
    def _heavy_fit(self, slow=(0, 1, 2)):
        base = np.ones(K)
        jitter = np.full(K, 0.05)
        base[list(slow)] = 2.0
        jitter[list(slow)] = 1.5
        model = LatencyModel(base=base, straggler_slowdown=1.0, jitter=jitter)
        mon = WorkerHealthMonitor(K)
        rng = np.random.default_rng(0)
        for _ in range(12):
            mon.record_step(model.sample(K, (), rng))
        return mon.fitted_model(), mon.straggler_scores()

    def test_policy_protocol(self):
        from repro_torch.control import Policy

        lad = _ladder()
        assert isinstance(ExpectedLatencyPolicy(lad), Policy)
        assert isinstance(QuantileLatencyPolicy(lad), Policy)

    def test_invalid_q_raises(self):
        with pytest.raises(ValueError):
            QuantileLatencyPolicy(_ladder(), q=1.5)

    def test_tail_ranking_disagrees_with_mean_under_heavy_tails(self):
        lad = _ladder()
        overhead = {"bec": 10.0, "tradeoff(p'=2)": 9.0, "polycode": 0.5}
        model, scores = self._heavy_fit()
        mean_pick = ExpectedLatencyPolicy(
            lad, overhead_s=overhead).select(model, scores)
        tail_pick = QuantileLatencyPolicy(
            lad, q=0.99, overhead_s=overhead).select(model, scores)
        assert mean_pick.rung == "polycode"
        assert tail_pick.rung == "tradeoff(p'=2)"
        assert tail_pick.quantile == 0.99
        assert tail_pick.quantile_latency_s > tail_pick.expected_latency_s

    def test_analytic_matches_sampled(self):
        lad = _ladder()
        model, scores = self._heavy_fit()
        zero = {r: 0.0 for r in lad.rungs}
        a = QuantileLatencyPolicy(lad, q=0.9, overhead_s=zero,
                                  analytic=True).estimate("bec", model, scores)
        s = QuantileLatencyPolicy(lad, q=0.9, overhead_s=zero, analytic=False,
                                  trials=4000).estimate("bec", model, scores)
        assert a.quantile_latency_s == pytest.approx(s.quantile_latency_s,
                                                     rel=0.1)

    def test_entry_bound_still_gates(self):
        lad = _ladder(L=L_BEC_INFEASIBLE)
        model, scores = self._heavy_fit()
        pol = QuantileLatencyPolicy(lad, overhead_s={r: 0.0 for r in lad.rungs})
        est = pol.select(model, scores)
        assert est.feasible and est.rung != "bec"

    def test_median_ranking_coincides_with_mean_for_iid_workers(self):
        lad = _ladder()
        zero = {r: 0.0 for r in lad.rungs}
        for seed in range(8):
            rng = np.random.default_rng(seed)
            model = LatencyModel(base=float(rng.uniform(0.5, 2.0)),
                                 straggler_slowdown=1.0,
                                 jitter=float(rng.uniform(0.1, 1.0)))
            scores = rng.uniform(0, 1, size=K)
            mean_rank = [e.rung for e in ExpectedLatencyPolicy(
                lad, overhead_s=zero, seed=seed).rank(model, scores)]
            med_rank = [e.rung for e in QuantileLatencyPolicy(
                lad, q=0.5, overhead_s=zero, analytic=False,
                seed=seed).rank(model, scores)]
            assert mean_rank == med_rank


class TestBatchedLadder:
    def test_bucket_roundup_serves_exactly(self):
        lad = _ladder()
        info = lad.prewarm(*SHAPES, batch_sizes=(4, 8))
        assert info["batch_buckets"] == (4, 8)
        assert info["builds"] == 3 * 3
        builds = lad.cache_info()["builds"]
        rng = np.random.default_rng(0)
        B = _ints(rng, SHAPES[1])
        for step, n in enumerate([3, 5, 8, 1, 4, 7]):
            lad.switch(lad.rungs[step % len(lad.rungs)])
            A = _ints(rng, (n,) + SHAPES[0])
            C = lad(A, B, erased=[0])
            assert C.shape[0] == n
            assert torch.equal(C, _oracle(A, B))
        assert lad.cache_info()["builds"] == builds

    def test_bucket_for(self):
        lad = _ladder()
        lad.prewarm(*SHAPES, batch_sizes=(4, 8))
        assert [lad.bucket_for(b) for b in (1, 4, 5, 9)] == [4, 4, 8, None]
        assert lad.batch_buckets == (4, 8)

    def test_batched_B_bypasses_buckets(self):
        lad = _ladder(include=["bec"])
        lad.prewarm(*SHAPES, batch_sizes=(4,))
        rng = np.random.default_rng(2)
        A = _ints(rng, (3,) + SHAPES[0])
        B = _ints(rng, (3,) + SHAPES[1])
        assert torch.equal(lad(A, B, erased=[0]), _oracle(A, B))

    def test_batch_beyond_buckets_compiles_fresh(self):
        lad = _ladder(include=["bec"])
        lad.prewarm(*SHAPES, batch_sizes=(2,))
        builds = lad.cache_info()["builds"]
        A = torch.zeros((5,) + SHAPES[0], dtype=torch.float64)
        B = torch.zeros(SHAPES[1], dtype=torch.float64)
        assert lad(A, B, erased=[]).shape[0] == 5
        assert lad.cache_info()["builds"] == builds + 1

    def test_invalid_bucket_raises(self):
        with pytest.raises(ValueError):
            _ladder().prewarm(*SHAPES, batch_sizes=(0,))

    @pytest.mark.parametrize("sizes,buckets,new_builds", [
        ((2, 4), (2, 4), 0),    # exactly on a bucket: no pad, no build
        ((6, 6), (2, 4), 1),    # past the largest: one build, memoised
        ((3, 1), (4,), 0),      # batch 1 after batched traffic pads to 4
    ], ids=["on_boundary", "beyond_largest", "one_after_batched"])
    def test_bucket_edges(self, sizes, buckets, new_builds):
        lad = _ladder(include=["bec"])
        lad.prewarm(*SHAPES, batch_sizes=buckets)
        builds = lad.cache_info()["builds"]
        rng = np.random.default_rng(3)
        B = _ints(rng, SHAPES[1])
        for n in sizes:
            A = _ints(rng, (n,) + SHAPES[0])
            C = lad(A, B, erased=[1])
            assert C.shape[0] == n
            assert torch.equal(C, _oracle(A, B))
        assert lad.cache_info()["builds"] == builds + new_builds


class TestSLOFallback:
    def _heavy_feed(self, slow=(0, 1, 2)):
        base = np.ones(K)
        jitter = np.full(K, 0.05)
        base[list(slow)] = 2.0
        jitter[list(slow)] = 1.5
        model = LatencyModel(base=base, straggler_slowdown=1.0, jitter=jitter)
        return lambda step, rng: model.sample(K, (), rng)

    def test_slo_s_requires_quantile(self):
        with pytest.raises(ValueError):
            AdaptiveServer(_ladder(), slo_s=1.0)

    def test_slo_quantile_becomes_primary_policy(self):
        srv = AdaptiveServer(_ladder(), slo_quantile=0.95)
        assert isinstance(srv.policy, QuantileLatencyPolicy)
        assert srv.policy is srv.slo_policy
        assert srv.policy.q == 0.95

    def test_violation_forces_switch_against_mean_ranking(self):
        overhead = {"bec": 10.0, "tradeoff(p'=2)": 9.0, "polycode": 0.5}
        lad = _ladder()
        lad.prewarm(*SHAPES)
        builds = lad.cache_info()["builds"]
        srv = AdaptiveServer(
            lad, policy=ExpectedLatencyPolicy(lad, overhead_s=overhead),
            feed=self._heavy_feed(), check_exact=True,
            slo_quantile=0.99, slo_s=12.0)
        assert srv.slo_policy.overhead_s == overhead
        A, B = _zeros()
        reports = srv.run(10, lambda i: (A, B))
        warm = reports[4:]
        assert any(r.slo_violation for r in warm)
        for r in warm:
            if r.slo_violation:
                assert r.rung == "tradeoff(p'=2)"
                assert r.predicted_tail_s < 12.0
        assert all(r.exact for r in reports)
        assert lad.cache_info()["builds"] == builds

    def test_no_violation_below_slo(self):
        lad = _ladder()
        lad.prewarm(*SHAPES)
        srv = AdaptiveServer(lad, feed=lambda s, r: _steady_times(slow=[5]),
                             slo_quantile=0.99, slo_s=50.0)
        A, B = _zeros()
        reports = srv.run(5, lambda i: (A, B))
        assert not any(r.slo_violation for r in reports)
        assert all(r.predicted_tail_s is not None for r in reports[2:])
        assert all(r.realized_s is None and r.q_effective is None
                   and not r.realized_violation for r in reports)


class TestObservedViolationFeedback:
    def test_feedback_requires_slo(self):
        with pytest.raises(ValueError):
            AdaptiveServer(_ladder(), feedback=True)
        with pytest.raises(ValueError):
            AdaptiveServer(_ladder(), slo_quantile=0.99, feedback=True)

    def test_realized_misses_tighten_q_and_force_tail_optimal(self):
        lad = _ladder()
        lad.prewarm(*SHAPES)
        pol = ExpectedLatencyPolicy(lad, overhead_s={r: 0.0 for r in lad.rungs})
        srv = AdaptiveServer(lad, policy=pol, feed=lambda s, r: _steady_times(),
                             slo_quantile=0.9, slo_s=0.5, feedback=True)
        A, B = _zeros()
        reports = srv.run(8, lambda i: (A, B))
        assert all(r.realized_violation for r in reports)
        assert all(r.realized_s == pytest.approx(1.0) for r in reports)
        assert reports[0].q_effective == 0.9
        assert reports[-1].q_effective == 0.999
        assert srv.feedback.force_tail_optimal
        assert srv.feedback.violations == 8

    def test_feedback_restates_user_supplied_quantile_primary(self):
        lad = _ladder()
        lad.prewarm(*SHAPES)
        primary = QuantileLatencyPolicy(
            lad, q=0.8, overhead_s={r: 0.0 for r in lad.rungs})
        srv = AdaptiveServer(lad, policy=primary,
                             feed=lambda s, r: _steady_times(),
                             slo_quantile=0.8, slo_s=0.5, feedback=True)
        A, B = _zeros()
        srv.run(8, lambda i: (A, B))
        assert primary is not srv.slo_policy
        assert primary.q == srv.slo_policy.q == 0.999

    def test_clean_run_holds_base_q(self):
        lad = _ladder()
        lad.prewarm(*SHAPES)
        srv = AdaptiveServer(lad, feed=lambda s, r: _steady_times(),
                             slo_quantile=0.9, slo_s=50.0, feedback=True)
        A, B = _zeros()
        reports = srv.run(8, lambda i: (A, B))
        assert not any(r.realized_violation for r in reports)
        assert all(r.q_effective == 0.9 for r in reports)

    def test_feedback_reduces_realized_violations_vs_static_q(self):
        """The reference's acceptance scenario at the twin bench's constants
        (imported, not copied)."""
        from benchmarks.torch_control_bench import (
            FB_CONFIG,
            FB_Q_BASE,
            FB_SEEDS,
            FB_SLO_S,
            FB_STEPS,
            FB_WARMUP,
            Q_OVERHEAD,
        )
        from repro_torch.chaos import make_scenario

        results = {}
        A, B = _zeros()
        for fb in (False, FeedbackConfig(**FB_CONFIG)):
            feed = make_scenario("heavy_tail").compile(K, seed=FB_SEEDS[0])
            lad = _ladder()
            lad.prewarm(*SHAPES)
            pol = ExpectedLatencyPolicy(lad, overhead_s=Q_OVERHEAD)
            srv = AdaptiveServer(lad, policy=pol, feed=feed,
                                 seed=FB_SEEDS[0], slo_quantile=FB_Q_BASE,
                                 slo_s=FB_SLO_S, feedback=fb)
            reports = srv.run(FB_STEPS, lambda i: (A, B))[FB_WARMUP:]
            realized = np.array([r.sim_latency_s + Q_OVERHEAD[r.rung]
                                 for r in reports])
            results[bool(fb)] = ((realized > FB_SLO_S).sum(),
                                 np.quantile(realized, 0.99))
        assert results[True][0] < results[False][0]
        assert results[True][1] <= results[False][1]


# -- the port against the JAX package -----------------------------------------

def _pkg(name):
    """(control module, chaos module, operand maker, ladder keywords)."""
    if name == "jax":
        from repro import chaos, control
        return control, chaos, lambda x: jnp.asarray(x, jnp.float64), {}
    from repro_torch import chaos, control
    return (control, chaos,
            lambda x: torch.as_tensor(x, dtype=torch.float64), {"device": CPU})


def _serve(name, case, seed=3):
    """One package's server over one parity case; returns (reports, Cs)."""
    control, chaos, arr, lad_kw = _pkg(name)
    rng = np.random.default_rng(seed + 100)
    A = arr(rng.integers(-2, 3, size=SHAPES[0]))
    B = arr(rng.integers(-2, 3, size=SHAPES[1]))
    Cs = []
    if case == "elastic_grow":
        sc = chaos.make_scenario("pool_resize", num_departing=3, depart_step=4,
                                 num_arriving=2, join_step=12)
        arriving = sc.arriving_ids(12, seed)
        pool = [i for i in range(12) if i not in set(arriving.tolist())]
        lad = control.PlanLadder(3, 2, 1, K=10, L=L_ALL_FEASIBLE,
                                 backend="reference", include=["polycode"],
                                 **lad_kw)
        lad.prewarm(*SHAPES)
        srv = control.AdaptiveServer(
            lad, policy=control.ExpectedLatencyPolicy(
                lad, overhead_s={"bec": 2.0, "polycode": 0.1}),
            feed=sc.compile(12, seed=seed), seed=seed, check_exact=True,
            universe=12, pool=pool)
        for i in range(16):
            if i == sc.join_step:
                srv.grow(arriving)
            Cs.append(srv.step(A, B)[0])
        return srv.reports, Cs
    scenario, sub_tasks, feedback = {
        "heavy_tail": ("heavy_tail", 1, False),
        "crawler_q4": ("crawler", 4, False),
        "pareto_feedback": ("pareto", 1, True),
    }[case]
    lad = control.PlanLadder(*GRID, K=K, L=L_ALL_FEASIBLE, backend="reference",
                             **lad_kw)
    lad.prewarm(*SHAPES, sub_tasks=sub_tasks)
    srv = control.AdaptiveServer(
        lad, policy=control.ExpectedLatencyPolicy(
            lad, overhead_s={"bec": 2.0, "tradeoff(p'=2)": 1.0,
                             "polycode": 0.1}, sub_tasks=sub_tasks),
        feed=chaos.make_scenario(scenario).compile(K, seed=seed), seed=seed,
        check_exact=True, slo_quantile=0.99, slo_s=2.5 if feedback else 4.0,
        feedback=feedback, sub_tasks=sub_tasks)
    for _ in range(12):
        Cs.append(srv.step(A, B)[0])
    return srv.reports, Cs


def _fields(report):
    out = dataclasses.asdict(report)
    out.pop("wall_ms")
    return out


class TestParityWithReference:
    @pytest.mark.parametrize("case", ["heavy_tail", "crawler_q4",
                                      "pareto_feedback", "elastic_grow"])
    def test_step_reports_and_products_equal(self, case):
        ref_reports, ref_C = _serve("jax", case)
        reports, Cs = _serve("torch", case)
        assert len(reports) == len(ref_reports)
        for got, want in zip(reports, ref_reports):
            assert _fields(got) == _fields(want), got.step
        for got, want in zip(Cs, ref_C):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert all(r.exact for r in reports)
        # the case must exercise the control plane, not idle through it
        assert any(r.switched or r.erased or r.progress for r in reports)

    @pytest.mark.parametrize("L", [257, 1 << 14, 1 << 20, 1 << 40])
    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_feasible_matches_reference(self, L, dtype):
        """``feasible`` takes the torch dtype itself: ``str(torch.float64)``
        would name no mantissa and raise."""
        from repro.control import PlanLadder as RefLadder

        lad = PlanLadder(*GRID, K=K, L=L, dtype=getattr(torch, dtype),
                         device=CPU)
        ref = RefLadder(*GRID, K=K, L=L, dtype=getattr(jnp, dtype))
        assert lad.rungs == ref.rungs
        assert ([lad.feasible(r) for r in lad.rungs]
                == [ref.feasible(r) for r in ref.rungs])
        assert lad.active == ref.active

    def test_cache_counters_match_reference(self):
        """The same prewarm and serving sequence gives the same group-wide
        build/hit/panel counters in both packages."""
        from repro.control import PlanLadder as RefLadder

        infos = []
        for lad, arr in ((RefLadder(*GRID, K=K, L=L_ALL_FEASIBLE),
                          lambda x: jnp.asarray(x, jnp.float64)),
                         (_ladder(), lambda x: torch.as_tensor(x, dtype=torch.float64))):
            lad.prewarm(*SHAPES, batch_sizes=(4,), sub_tasks=2)
            A, B = arr(np.ones((3,) + SHAPES[0])), arr(np.ones(SHAPES[1]))
            for step, rung in enumerate(lad.rungs):
                lad.switch(rung)
                lad(A, B, erased=[step])
                lad(A[0], B, progress=np.r_[0.5, np.ones(K - 1)], sub_tasks=2)
            info = lad.cache_info()
            info.pop("overhead_s", None)
            infos.append(info)
        assert infos[0] == infos[1]


class TestBenchTwin:
    def test_regime_row_equals_reference_bench(self):
        from benchmarks import control_bench, torch_control_bench
        from repro.core.numerics import enable_x64

        with enable_x64():
            want = control_bench._run_regime(control_bench.L_SMALL, 3, seed=20)
        got = torch_control_bench._run_regime(
            torch_control_bench.L_SMALL, 3, seed=20,
            lad=torch_control_bench.ladder_kw("reference", CPU))
        assert got == want

    def test_feedback_gate_passes(self):
        from benchmarks import torch_control_bench as bench

        rows = bench._run_feedback_sweep(bench.ladder_kw("reference", CPU))
        bench.check_feedback(rows)
        assert {r["policy"] for r in rows} == {"static_q", "feedback"}

    def test_mesh_backend_not_ported(self):
        """The mesh backend runs only the partial sweep, as the reference's
        ``control_bench.py`` refuses it for the others."""
        from benchmarks import torch_control_bench as bench

        with pytest.raises(ValueError, match="only applies to the partial_sweep sweep"):
            bench.run("elastic_sweep", backend="mesh", device=CPU)
