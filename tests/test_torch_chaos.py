"""The port's chaos harness (``repro_torch.chaos``) on the CPU.

Mirrors ``tests/test_chaos.py``: the scenario DSL, trace record/replay,
the feedback law, and the golden regressions.  The yardstick is the
checked-in ``tests/golden/*.jsonl``, which the JAX package wrote: the
port's canonical recipe must reproduce every control trace bit for bit
(``Trace.diff == []``, ``wall_ms`` excluded) on every backend.  The
scenario feeds are held against the reference's to the last bit too.
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

jax.config.update("jax_enable_x64", True)

from repro_torch.chaos import (  # noqa: E402
    Scenario,
    Trace,
    TraceRecorder,
    make_scenario,
    scenario_names,
    trace_matrix,
    verify_replay,
)
from repro_torch.chaos.golden import (  # noqa: E402
    GOLDEN_K,
    golden_names,
    golden_trace,
    replay_golden,
)
from repro_torch.chaos.serialize import report_to_dict  # noqa: E402
from repro_torch.control import StepReport, WorkerHealthMonitor  # noqa: E402
from repro_torch.control.feedback import FeedbackConfig, ViolationFeedback  # noqa: E402

K = 12
STEPS = 16
GOLDEN_DIR = Path(__file__).parent / "golden"
CPU = "cpu"

ARCHETYPES = ("iid", "heavy_tail", "pareto", "bursty", "flapping", "rack",
              "pool_resize", "crawler", "degrading")
#: the control traces (``serve_heavy_tail.jsonl`` is the serve tier's).
CONTROL_KEYS = ("bursty", "crawler", "degrading", "flapping", "heavy_tail",
                "iid", "pareto", "pool_resize", "rack", "pareto_feedback",
                "crawler_partial", "pool_resize_shrink", "pool_resize_grow")


def _report_like(step):
    """A StepReport carrying a TraceStep's compared fields (wall_ms 0)."""
    fields = {f.name: getattr(step, f.name) for f in dataclasses.fields(step)
              if f.name != "times"}
    return StepReport(wall_ms=0.0, **fields)


class TestScenarioDSL:
    def test_catalog_registered(self):
        assert set(ARCHETYPES) <= set(scenario_names())
        with pytest.raises(KeyError):
            make_scenario("thundering_herd")

    def test_overrides_and_frozen(self):
        sc = make_scenario("heavy_tail", num_stragglers=5, heavy_jitter=2.0)
        assert sc.num_stragglers == 5 and sc.heavy_jitter == 2.0
        with pytest.raises(Exception):
            sc.num_stragglers = 1

    @pytest.mark.parametrize("name", ARCHETYPES)
    def test_seeded_scenarios_reproducible(self, name):
        sc = make_scenario(name)
        a = trace_matrix(sc, K, STEPS, seed=3)
        b = trace_matrix(sc, K, STEPS, seed=3)
        c = trace_matrix(sc, K, STEPS, seed=4)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
        assert a.shape == (STEPS, K)
        assert np.all(np.isfinite(a)) and np.all(a > 0)

    @pytest.mark.parametrize("name", ARCHETYPES)
    def test_feed_matches_reference_bit_for_bit(self, name):
        """The copy of the scenario DSL draws exactly the reference's times."""
        from repro.chaos import make_scenario as ref_make_scenario
        from repro.chaos import trace_matrix as ref_trace_matrix

        for seed in (0, 7):
            np.testing.assert_array_equal(
                trace_matrix(make_scenario(name), K, STEPS, seed=seed),
                ref_trace_matrix(ref_make_scenario(name), K, STEPS, seed=seed))

    @pytest.mark.parametrize("name", ARCHETYPES)
    def test_calm_variant_flags_nobody(self, name):
        feed = make_scenario(name).calm().compile(K, seed=3)
        mon = WorkerHealthMonitor(K)
        for step in range(8):
            mon.record_step(feed(step, None))
        assert mon.stragglers().size == 0

    def test_heavy_tail_monitor_flags_slow_set(self):
        feed = make_scenario("heavy_tail").compile(K, seed=3)
        mon = WorkerHealthMonitor(K)
        for step in range(10):
            mon.record_step(feed(step, None))
        assert mon.stragglers().size == 3

    def test_rack_failure_degrades_one_rack_together(self):
        sc = make_scenario("rack", healthy_jitter=0.0, rack_jitter=0.0)
        before = sc.times(sc.fail_step - 1, K, seed=5)
        after = sc.times(sc.fail_step, K, seed=5)
        slowed = np.flatnonzero(after > 2.0 * before)
        assert slowed.size == K // sc.racks
        assert len({int(w) % sc.racks for w in slowed}) == 1

    def test_pool_resize_departures_and_arrivals(self):
        sc = make_scenario("pool_resize", healthy_jitter=0.0)
        pre = sc.times(0, K, seed=1)
        mid = sc.times(sc.join_step, K, seed=1)
        post = sc.times(sc.depart_step, K, seed=1)
        assert (pre > 10).sum() == sc.num_arriving
        assert (mid > 10).sum() == 0
        assert (post > 10).sum() == sc.num_departing

    def test_crawler_set_is_persistent(self):
        sc = make_scenario("crawler", healthy_jitter=0.0, crawl_jitter=0.0)
        early = sc.times(0, K, seed=2)
        late = sc.times(40, K, seed=2)
        slow = np.flatnonzero(early > 1.5 * sc.base)
        assert slow.size == sc.num_crawlers
        np.testing.assert_array_equal(
            slow, np.flatnonzero(late > 1.5 * sc.base))

    def test_degrading_ramp_monotone_then_capped(self):
        sc = make_scenario("degrading", healthy_jitter=0.0, degrade_jitter=0.0)
        victims = np.flatnonzero(sc.times(100, K, seed=4) > 2.0 * sc.base)
        assert victims.size == sc.num_degrading
        v = victims[0]
        ramp = [sc.times(s, K, seed=4)[v] for s in (0, 10, 20, 100, 200)]
        assert all(a <= b + 1e-12 for a, b in zip(ramp, ramp[1:]))
        assert ramp[-1] == pytest.approx(ramp[-2])
        assert ramp[-1] <= sc.max_factor * sc.base + 1e-9

    def test_compile_validates(self):
        with pytest.raises(ValueError):
            make_scenario("iid").compile(0)

        class Broken(Scenario):
            def times(self, step, K, seed):
                return np.zeros(K - 1)

        with pytest.raises(ValueError):
            Broken().compile(4)(0, None)
        with pytest.raises(NotImplementedError):
            Scenario().times(0, 4, 0)


class TestTraceRoundTrip:
    def _small_trace(self):
        return golden_trace("heavy_tail", steps=6, device=CPU)

    def test_jsonl_roundtrip_bit_exact(self, tmp_path):
        trace = self._small_trace()
        loaded = Trace.load(trace.save(tmp_path / "t.jsonl"))
        assert loaded == trace

    def test_saved_lines_equal_the_reference_writer(self, tmp_path):
        """The port writes the JSONL the reference writes (version 1)."""
        from repro.chaos import Trace as RefTrace

        trace = self._small_trace()
        path = trace.save(tmp_path / "t.jsonl")
        ref = RefTrace.load(path)
        assert ref.save(tmp_path / "r.jsonl").read_text() == path.read_text()

    def test_header_validation(self, tmp_path):
        p = tmp_path / "bad.jsonl"
        p.write_text('{"kind": "step"}\n')
        with pytest.raises(ValueError):
            Trace.load(p)
        p.write_text("")
        with pytest.raises(ValueError):
            Trace.load(p)

    def test_replay_feed_is_verbatim_and_bounded(self):
        trace = self._small_trace()
        feed = trace.feed()
        for s in trace.steps:
            np.testing.assert_array_equal(feed(s.step, None), np.asarray(s.times))
        with pytest.raises(IndexError):
            feed(len(trace.steps), None)

    def test_recorder_requires_recorded_steps(self):
        trace = self._small_trace()
        rec = TraceRecorder(lambda step, rng: np.ones(GOLDEN_K), GOLDEN_K)
        with pytest.raises(ValueError):
            rec.finish([_report_like(trace.steps[0])])

    def test_diff_catches_divergence(self):
        trace = self._small_trace()
        reports = [_report_like(s) for s in trace.steps]
        assert trace.diff(reports) == []
        tampered = list(reports)
        tampered[2] = dataclasses.replace(tampered[2], rung="polycode",
                                          sim_latency_s=999.0)
        diffs = trace.diff(tampered)
        assert any("rung" in d for d in diffs)
        assert any("sim_latency_s" in d for d in diffs)
        with pytest.raises(AssertionError):
            verify_replay(trace, tampered)
        assert len(trace.diff(reports[:-1])) == 1

    def test_report_serialisation_drops_only_wall_ms(self):
        rep = _report_like(self._small_trace().steps[0])
        fields = {f.name for f in dataclasses.fields(StepReport)}
        assert set(report_to_dict(rep)) == fields - {"wall_ms"}


class TestReplayDeterminism:
    @pytest.mark.parametrize("key", ["heavy_tail", "pool_resize",
                                     "pareto_feedback", "crawler_partial"])
    def test_replay_reproduces_run_bit_exactly(self, key):
        trace = golden_trace(key, steps=8, device=CPU)
        verify_replay(trace, replay_golden(key, trace, device=CPU))

    def test_replay_exercises_switches(self):
        trace = golden_trace("heavy_tail", steps=8, device=CPU)
        assert any(s.switched for s in trace.steps)
        assert any(s.erased for s in trace.steps)

    @pytest.mark.parametrize("key", ["pool_resize_shrink", "pool_resize_grow"])
    def test_elastic_replay_reproduces_handoff(self, key):
        trace = golden_trace(key, device=CPU)
        pools = {s.pool for s in trace.steps}
        assert len(pools) >= (3 if key == "pool_resize_grow" else 2)
        assert any(s.respecialize for s in trace.steps)
        assert all(s.exact for s in trace.steps)
        verify_replay(trace, replay_golden(key, trace, device=CPU))


class TestGoldenTraces:
    """The port against the checked-in recordings of the JAX package."""

    def test_control_keys_are_the_catalog(self):
        assert golden_names() == tuple(sorted(ARCHETYPES)) + (
            "pareto_feedback", "crawler_partial", "pool_resize_shrink",
            "pool_resize_grow")
        assert set(golden_names()) == set(CONTROL_KEYS)

    @pytest.mark.parametrize("key", CONTROL_KEYS)
    def test_matches_checked_in_golden(self, key):
        golden = Trace.load(GOLDEN_DIR / f"{key}.jsonl")
        fresh = golden_trace(key, device=CPU)
        assert fresh.diff([_report_like(s) for s in golden.steps]) == []
        assert [s.times for s in fresh.steps] == [s.times for s in golden.steps]
        assert fresh.meta == golden.meta

    @pytest.mark.parametrize("backend", ["fused", "staged"])
    def test_golden_replays_on_every_backend(self, backend):
        """The kernels' plain versions serve the same decisions: the backend
        moves no recorded field."""
        for key in CONTROL_KEYS:
            golden = Trace.load(GOLDEN_DIR / f"{key}.jsonl")
            reports = replay_golden(key, golden, device=CPU, backend=backend)
            assert golden.diff(reports) == [], key
            assert all(r.exact for r in reports), key

    def test_elastic_goldens_pin_the_handoff(self):
        shrink = Trace.load(GOLDEN_DIR / "pool_resize_shrink.jsonl")
        grow = Trace.load(GOLDEN_DIR / "pool_resize_grow.jsonl")
        for golden in (shrink, grow):
            assert all(s.pool is not None for s in golden.steps)
            assert all(s.exact for s in golden.steps)
        first, last = shrink.steps[0].pool, shrink.steps[-1].pool
        assert len(last) < len(first)
        assert set(last) < set(first)
        assert shrink.steps[0].rung != shrink.steps[-1].rung
        mid = next(s for s in grow.steps
                   if len(s.pool) < len(grow.steps[0].pool))
        final = grow.steps[-1].pool
        assert len(final) > len(mid.pool)
        assert final[:len(mid.pool)] == mid.pool
        assert grow.steps[-1].rung == grow.steps[0].rung

    def test_crawler_partial_golden_consumes_fractions(self):
        golden = Trace.load(GOLDEN_DIR / "crawler_partial.jsonl")
        assert all(s.progress is not None for s in golden.steps)
        assert [x for s in golden.steps for x in s.progress if 0.0 < x < 1.0]
        assert all(s.exact for s in golden.steps)

    def test_unknown_key_raises(self):
        with pytest.raises(KeyError):
            golden_trace("serve_heavy_tail", device=CPU)

    @pytest.mark.parametrize("key", CONTROL_KEYS)
    def test_switch_and_handoff_counters_count_their_events(self, key):
        """Over each golden replay ``ladder.switch`` counts the rung changes
        ``PlanLadder.switch`` makes, i.e. every change of the served rung
        but one made by an in-step handoff (a step whose report says
        ``respecialize``), which re-lowers the ladder and picks its rung
        itself; ``control.switch`` counts every step whose rung changed.
        ``ladder.respecialize`` counts the handoffs executed (pool
        changes), ``control.respecialize`` the steps that decided one."""
        from repro_torch import obs

        golden = Trace.load(GOLDEN_DIR / f"{key}.jsonl")
        session = obs.enable(fresh=True)
        try:
            reports = replay_golden(key, golden, device=CPU)
        finally:
            obs.disable()
        assert golden.diff(reports) == [] and not reports[0].switched
        changed = [b for a, b in zip(reports, reports[1:]) if b.rung != a.rung]
        by_handoff = [r for r in changed if r.respecialize]
        handoffs = sum(a.pool != b.pool for a, b in zip(reports, reports[1:]))
        total = session.registry.total
        assert changed == [r for r in reports if r.switched]
        assert total("control.switch") == len(changed)
        assert total("ladder.switch") == len(changed) - len(by_handoff)
        assert total("control.respecialize") == sum(r.respecialize for r in reports)
        assert total("ladder.respecialize") == handoffs
        if key.startswith("pool_resize_"):
            assert by_handoff and handoffs > 0


class TestFeedbackLaw:
    def _rate(self, violations, window=8, **cfg):
        fb = ViolationFeedback(0.95, 1.0, FeedbackConfig(
            window=window, min_observations=window, **cfg))
        for i in range(window):
            fb.observe(2.0 if i < violations else 0.5)
        return fb

    def test_q_monotone_in_realized_violation_rate(self):
        for cfg in ({}, {"q_min": 0.5}, {"gain": 5.0}):
            qs = [self._rate(v, **cfg).effective_q() for v in range(9)]
            assert all(a <= b for a, b in zip(qs, qs[1:])), cfg
            assert qs[-1] == 0.999

    def test_threshold_monotone_non_increasing(self):
        ths = [self._rate(v).effective_threshold(0.5) for v in range(9)]
        assert all(a >= b for a, b in zip(ths, ths[1:]))
        assert ths[0] == 0.5 and ths[-1] >= 0.1

    def test_loosening_floors_at_base_unless_opted_in(self):
        assert self._rate(0).effective_q() == 0.95
        assert self._rate(0, q_min=0.5).effective_q() < 0.95

    def test_holds_base_until_min_observations(self):
        fb = ViolationFeedback(0.95, 1.0, FeedbackConfig(min_observations=4))
        for _ in range(3):
            fb.observe(5.0)
            assert fb.effective_q() == 0.95
        fb.observe(5.0)
        assert fb.effective_q() > 0.95

    def test_force_tail_optimal_after_consecutive_misses(self):
        fb = ViolationFeedback(0.99, 1.0, FeedbackConfig(force_after=3))
        for _ in range(2):
            fb.observe(2.0)
        assert not fb.force_tail_optimal
        fb.observe(2.0)
        assert fb.force_tail_optimal
        fb.observe(0.5)
        assert not fb.force_tail_optimal

    def test_window_slides(self):
        fb = ViolationFeedback(0.95, 1.0, FeedbackConfig(
            window=4, min_observations=1))
        for _ in range(4):
            fb.observe(2.0)
        assert fb.realized_rate == 1.0
        for _ in range(4):
            fb.observe(0.5)
        assert fb.realized_rate == 0.0
        assert fb.violations == 4 and fb.observations == 8

    @pytest.mark.parametrize("bad", [
        lambda: ViolationFeedback(0.0, 1.0),
        lambda: ViolationFeedback(0.99, -1.0),
        lambda: FeedbackConfig(window=0),
        lambda: FeedbackConfig(q_min=0.9, q_max=0.5),
        lambda: FeedbackConfig(target_rate=2.0),
        lambda: FeedbackConfig(window=4, min_observations=8),
        lambda: ViolationFeedback(0.9995, 1.0),
    ])
    def test_validation(self, bad):
        with pytest.raises(ValueError):
            bad()


class TestObsNamesMatchReference:
    @pytest.mark.parametrize("key", ["pareto_feedback", "pool_resize_grow"])
    def test_control_metrics_and_spans_equal_the_reference(self, key):
        """The control plane's counters, histogram and spans carry the
        reference's names, labels and values: the Prometheus lines of every
        ``control.*``/``ladder.*`` instrument and the sequence of their spans
        (name and attributes) are equal after the same golden run."""
        from repro import obs as ref_obs
        from repro.chaos.golden import golden_trace as ref_golden_trace
        from repro_torch import obs

        out = {}
        for name, mod, run in (("jax", ref_obs, ref_golden_trace),
                               ("torch", obs,
                                lambda k: golden_trace(k, device=CPU))):
            session = mod.enable(fresh=True)
            try:
                run(key)
                lines = [ln for ln in session.registry.to_prometheus().splitlines()
                         if ln.removeprefix("# TYPE ").startswith(
                             ("control_", "ladder_"))]
                spans = [(s.name, s.attrs) for s in session.recorder.spans
                         if s.name.startswith(("control.", "ladder."))]
            finally:
                mod.disable()
            out[name] = (lines, spans)
        assert out["torch"] == out["jax"]
        lines, spans = out["torch"]
        names = {s[0] for s in spans}
        assert {"control.begin_step", "control.execute", "control.complete_step",
                "ladder.prewarm", "ladder.prewarm.rung"} <= names
        assert any(ln.startswith("control_sim_latency_s_bucket") for ln in lines)
