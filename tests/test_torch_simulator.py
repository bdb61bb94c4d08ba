"""The port's straggler simulator (``repro_torch.core.simulator``) against
the JAX package's ``repro.core.simulator``.

Mirrors the simulator cases of ``tests/test_points_sim.py`` that need no
chaos feed, and holds the two packages to EXACT equality on the same seeds:
both are the same numpy code, so every latency, sample, CDF value, quantile
and mean must agree bit for bit.
"""
import numpy as np
import pytest

from repro.core import simulator as jsim
from repro_torch.core import LatencyModel, WorkerTimes, simulate_completion
from repro_torch.core import simulator as sim


# -- the reference's simulator cases, on the port -----------------------------

class TestSimulator:
    def test_threshold_latency_flat_then_jump(self):
        """Paper Fig. 1 shape: tau=4, K=10 -> flat for S <= 6, jump at 7."""
        model = LatencyModel(base=1.0, straggler_slowdown=2.0)
        med = {}
        for S in (0, 2, 4, 6, 7, 8):
            lat = simulate_completion(10, 4, S, model, trials=50, seed=1)
            med[S] = float(np.median(lat))
        assert med[0] == med[2] == med[4] == med[6] == 1.0
        assert med[7] == 2.0 and med[8] == 2.0

    def test_baseline_degrades_earlier(self):
        """tau=9 (polycode): ANY 2 stragglers already hurt (paper Fig. 1)."""
        model = LatencyModel(base=1.0, straggler_slowdown=2.0)
        lat = simulate_completion(10, 9, 2, model, trials=50, seed=2)
        assert float(np.median(lat)) == 2.0

    def test_survivor_set(self):
        wt = WorkerTimes(np.array([5.0, 1.0, 3.0, 2.0]))
        assert wt.survivors_at_threshold(2).tolist() == [1, 3]


class TestSimulatorProperties:
    def _times(self, K=10, seed=0):
        return WorkerTimes(np.random.default_rng(seed).exponential(1.0, K))

    def test_completion_monotone_in_tau(self):
        for seed in range(5):
            wt = self._times(seed=seed)
            lats = [wt.completion_for_threshold(tau) for tau in range(1, 11)]
            assert all(a <= b for a, b in zip(lats, lats[1:]))

    def test_survivors_consistent_with_finish_order(self):
        for seed in range(5):
            wt = self._times(seed=seed)
            for tau in (1, 4, 10):
                surv = wt.survivors_at_threshold(tau)
                assert len(set(surv.tolist())) == tau
                cutoff = wt.completion_for_threshold(tau)
                assert wt.finish[surv].max() == cutoff
                others = np.setdiff1d(np.arange(10), surv)
                if others.size:
                    assert wt.finish[others].min() >= cutoff

    def test_jitter_path_deterministic_under_seed(self):
        model = LatencyModel(base=1.0, straggler_slowdown=2.0, jitter=0.3)
        a = simulate_completion(10, 4, 3, model, trials=40, seed=7)
        b = simulate_completion(10, 4, 3, model, trials=40, seed=7)
        np.testing.assert_array_equal(a, b)
        c = simulate_completion(10, 4, 3, model, trials=40, seed=8)
        assert not np.array_equal(a, c)

    def test_per_worker_base_and_validation(self):
        base = np.linspace(1.0, 2.0, 10)
        model = LatencyModel(base=base, straggler_slowdown=3.0)
        t = model.sample(10, [0], np.random.default_rng(0))
        np.testing.assert_allclose(t[1:], base[1:])
        assert t[0] == 3.0
        with pytest.raises(ValueError):
            model.sample(8, [], np.random.default_rng(0))

    def test_injectable_feed_overrides_model(self):
        """A hand-written feed drives the protocol in place of the model."""
        def feed(t, rng):
            return np.arange(10, dtype=np.float64)[::-1] + t

        lat = simulate_completion(10, 4, 0, None, decode_time=0.5, trials=6,
                                  feed=feed)
        np.testing.assert_array_equal(lat, [3.5 + t for t in range(6)])
        with pytest.raises(ValueError):
            simulate_completion(10, 4, 0, None)  # neither model nor feed
        with pytest.raises(ValueError, match="shape"):
            simulate_completion(10, 4, 0, None, feed=lambda t, rng: np.ones(3))

    def test_masked_completion_bridges_sync_and_async(self):
        wt = self._times(seed=3)
        tau = 4
        mask = np.ones(10)
        mask[np.argsort(wt.finish)[tau:]] = 0.0
        assert wt.completion_with_mask(mask) == wt.completion_for_threshold(tau)
        assert wt.completion_with_mask(np.ones(10)) >= \
            wt.completion_for_threshold(tau)
        with pytest.raises(ValueError):
            wt.completion_with_mask(np.zeros(10))

    def test_completion_cdf_and_quantile(self):
        lat = np.array([1.0, 2.0, 3.0, 4.0])
        np.testing.assert_allclose(
            sim.completion_cdf(lat, np.array([0.5, 1.0, 2.5, 4.0])),
            [0.0, 0.25, 0.5, 1.0])
        assert sim.completion_quantile(lat, 0.5) == 2.5


class TestMaskedCompletionDistribution:
    def _model(self, K=6):
        return LatencyModel(base=np.linspace(1.0, 2.0, K),
                            straggler_slowdown=1.0, jitter=np.full(K, 0.3))

    def test_matches_empirical(self):
        model = self._model()
        mask = np.array([1, 1, 0, 1, 1, 0], dtype=float)
        rng = np.random.default_rng(0)
        keep = mask.astype(bool)
        samples = np.array([model.sample(6, (), rng)[keep].max()
                            for _ in range(40000)])
        for q in (0.1, 0.5, 0.9, 0.99):
            analytic = sim.masked_completion_quantile(model, mask, q)
            empirical = float(np.quantile(samples, q))
            assert abs(analytic - empirical) < 0.05 * max(empirical, 1.0)

    def test_analytic_mean_matches_empirical(self):
        model = self._model()
        mask = np.array([1, 0, 1, 1, 0, 1], dtype=float)
        rng = np.random.default_rng(1)
        keep = mask.astype(bool)
        samples = np.array([model.sample(6, (), rng)[keep].max()
                            for _ in range(40000)])
        assert sim.masked_completion_mean(model, mask) == pytest.approx(
            samples.mean(), rel=0.02)
        det = LatencyModel(base=np.linspace(1.0, 2.0, 6),
                           straggler_slowdown=1.0, jitter=0.0)
        assert sim.masked_completion_mean(det, np.ones(6)) == 2.0

    def test_q_zero_is_essential_min(self):
        model = self._model()
        assert sim.masked_completion_quantile(model, np.ones(6), 0.0) == 2.0
        mask = np.array([1, 1, 1, 0, 0, 0], dtype=float)
        assert sim.masked_completion_quantile(model, mask, 0.0) == \
            pytest.approx(1.4)

    def test_q_one_unbounded_iff_jitter(self):
        assert sim.masked_completion_quantile(
            self._model(), np.ones(6), 1.0) == np.inf
        det = LatencyModel(base=np.linspace(1.0, 2.0, 6),
                           straggler_slowdown=1.0, jitter=0.0)
        for q in (0.0, 0.5, 1.0):
            assert sim.masked_completion_quantile(det, np.ones(6), q) == 2.0

    def test_single_worker(self):
        model = LatencyModel(base=2.0, straggler_slowdown=1.0, jitter=0.5)
        mask = np.ones(1)
        q = 0.9
        expect = 2.0 + 1.0 * (-np.log(1 - q))
        assert sim.masked_completion_quantile(model, mask, q) == \
            pytest.approx(expect)
        assert sim.masked_completion_cdf(model, mask, expect) == \
            pytest.approx(q)
        assert sim.masked_completion_cdf(model, mask, 1.9) == 0.0

    def test_saturated_budget_mask(self):
        model = self._model()
        mask = np.zeros(6)
        mask[0] = 1.0  # base 1.0, scale 0.3
        expect = 1.0 + 0.3 * (-np.log(1 - 0.5))
        assert sim.masked_completion_quantile(model, mask, 0.5) == \
            pytest.approx(expect, rel=1e-6)

    def test_all_erased_and_bad_q_raise(self):
        with pytest.raises(ValueError):
            sim.masked_completion_quantile(self._model(), np.zeros(6), 0.5)
        with pytest.raises(ValueError):
            sim.masked_completion_quantile(self._model(), np.ones(6), 1.5)

    def test_cdf_vectorised_and_monotone(self):
        F = sim.masked_completion_cdf(self._model(), np.ones(6),
                                      np.linspace(0.0, 10.0, 50))
        assert F.shape == (50,)
        assert np.all(np.diff(F) >= 0)
        assert F[0] == 0.0 and F[-1] > 0.99

    def test_per_worker_jitter_sampling(self):
        model = LatencyModel(base=1.0, straggler_slowdown=1.0,
                             jitter=np.array([0.0, 0.0, 1.0]))
        t = model.sample(3, (), np.random.default_rng(0))
        np.testing.assert_allclose(t[:2], 1.0)
        assert t[2] > 1.0
        assert model.has_jitter
        with pytest.raises(ValueError):
            model.jitter_vector(5)


# -- exact parity with the JAX package ----------------------------------------

_MODELS = [
    dict(base=1.0, straggler_slowdown=2.0),
    dict(base=0.0123, straggler_slowdown=2.0, jitter=0.3),
    dict(base=np.linspace(0.5, 2.0, 10), straggler_slowdown=3.0,
         jitter=np.r_[np.zeros(5), np.full(5, 0.7)]),
]


def _pair(kw):
    return LatencyModel(**kw), jsim.LatencyModel(**kw)


@pytest.mark.parametrize("kw", _MODELS)
@pytest.mark.parametrize("tau", [4, 9])
def test_simulate_completion_equals_reference(kw, tau):
    model, jmodel = _pair(kw)
    for S in range(0, 9):
        a = simulate_completion(10, tau, S, model, decode_time=0.0031,
                                trials=20, seed=S)
        b = jsim.simulate_completion(10, tau, S, jmodel, decode_time=0.0031,
                                     trials=20, seed=S)
        assert a.tobytes() == b.tobytes(), S


@pytest.mark.parametrize("kw", _MODELS)
def test_stable_sample_equals_reference(kw):
    model, jmodel = _pair(kw)
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for stragglers in ([], [0, 3], [9], list(range(7))):
        for stable in (True, False):
            a = model.sample(10, stragglers, rng, stable=stable)
            b = jmodel.sample(10, stragglers, jrng, stable=stable)
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kw", _MODELS)
def test_masked_completion_equals_reference(kw):
    model, jmodel = _pair(kw)
    masks = [np.ones(10), np.r_[np.ones(4), np.zeros(6)],
             np.r_[0.5, 0.25, np.ones(6), 0.0, 0.0]]
    ts = np.linspace(0.0, 8.0, 33)
    for mask in masks:
        assert (sim.masked_completion_cdf(model, mask, ts).tobytes()
                == jsim.masked_completion_cdf(jmodel, mask, ts).tobytes())
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert (sim.masked_completion_quantile(model, mask, q)
                    == jsim.masked_completion_quantile(jmodel, mask, q))
        assert (sim.masked_completion_mean(model, mask)
                == jsim.masked_completion_mean(jmodel, mask))


def test_worker_times_and_summaries_equal_reference():
    rng = np.random.default_rng(4)
    for _ in range(5):
        finish = rng.exponential(1.0, 10)
        wt, jwt = WorkerTimes(finish), jsim.WorkerTimes(finish)
        prog = rng.random(10)
        for tau in (1, 4, 9):
            assert wt.completion_for_threshold(tau) == \
                jwt.completion_for_threshold(tau)
            assert (wt.survivors_at_threshold(tau).tolist()
                    == jwt.survivors_at_threshold(tau).tolist())
        assert wt.completion_with_progress(prog) == \
            jwt.completion_with_progress(prog)
        lat = rng.exponential(1.0, 50)
        ts = np.linspace(0, 3, 7)
        assert (sim.completion_cdf(lat, ts).tobytes()
                == jsim.completion_cdf(lat, ts).tobytes())
        assert sim.completion_quantile(lat, 0.99) == \
            jsim.completion_quantile(lat, 0.99)


def test_measure_worker_time_is_median_of_repeats():
    calls = []
    t = sim.measure_worker_time(lambda: calls.append(1), repeats=5)
    assert len(calls) == 5 and 0.0 <= t < 1.0
