"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, plus its instrumentation sites in the port.

Mirrors ``tests/test_obs.py``'s span, metrics, disabled-path, exporter and
report cases on the port, and holds the two packages together:

* the same call sequence under a ``SettableClock`` gives identical Perfetto
  events, Prometheus text and ``report.render`` output;
* ``span_id_for`` is equal over a hypothesis sweep (the golden traces that
  later slices replay record these IDs);
* the JAX and port facades end the same four-pattern run with equal
  ``runtime.executable.{compile,hit}`` and panel-cache counters, and equal
  ``executable_cache_size()``.

The port's ``kernel.call`` counts every call, where JAX counts a call inside
``jit`` once per trace, so it is held against the port's own launch and
call counts, not against JAX.
"""
import json
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import make_plan as jmake_plan  # noqa: E402
from repro.obs.export import perfetto_events as jperfetto_events  # noqa: E402
from repro.obs.report import render as jrender  # noqa: E402
from repro.obs.spans import span_id_for as jspan_id_for  # noqa: E402
from repro.runtime import CodedMatmul as JCodedMatmul  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import make_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs.export import (parse_prometheus, perfetto_events,  # noqa: E402
                                    write_perfetto, write_prometheus)
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: E402
from repro_torch.obs.report import main as report_main  # noqa: E402
from repro_torch.obs.report import render  # noqa: E402
from repro_torch.obs.spans import span_id_for  # noqa: E402
from repro_torch.runtime import CodedMatmul  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_session():
    """Every test starts with observability OFF in both packages and
    leaves it off."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


# -- spans --------------------------------------------------------------------

class TestSpans:
    def test_nesting_records_parent_chain(self):
        obs.enable(fresh=True)
        with obs.span("outer") as outer:
            with obs.span("inner") as inner:
                pass
        spans = {s.name: s for s in obs.session().recorder.spans}
        assert spans["inner"].parent == outer.sid
        assert spans["outer"].parent is None
        assert inner.sid != outer.sid
        assert [s.name for s in obs.session().recorder.spans] == \
            ["inner", "outer"]

    def test_exception_marks_span_failed_and_unwinds_stack(self):
        obs.enable(fresh=True)
        with pytest.raises(RuntimeError, match="boom"):
            with obs.span("outer"):
                with obs.span("inner"):
                    raise RuntimeError("boom")
        spans = {s.name: s for s in obs.session().recorder.spans}
        assert spans["inner"].ok is False
        assert spans["outer"].ok is False
        with obs.span("after"):
            pass
        assert {s.name: s.parent for s in obs.session().recorder.spans}[
            "after"] is None

    def test_generator_leak_does_not_corrupt_siblings(self):
        obs.enable(fresh=True)

        def gen():
            with obs.span("leaked"):
                yield

        with obs.span("outer"):
            g = gen()
            next(g)  # opens "leaked" and never closes it
            del g
        with obs.span("after"):
            pass
        spans = {s.name: s for s in obs.session().recorder.spans}
        assert spans["after"].parent is None

    def test_settable_clock_stamps_simulated_time(self):
        clock = obs.SettableClock(10.0)
        obs.enable(fresh=True, clock=clock)
        with obs.span("step"):
            clock.set(12.5)
        (s,) = obs.session().recorder.spans
        assert (s.start_s, s.end_s) == (10.0, 12.5)
        assert s.duration_s == 2.5
        clock.set(1.0)
        assert clock() == 12.5

    def test_emit_records_pretimed_interval_verbatim(self):
        obs.enable(fresh=True)
        s = obs.emit_span("serve.worker_stage", 3.0, 7.0,
                          track="premium", lane="workers", batch=4)
        assert (s.start_s, s.end_s, s.track, s.lane) == \
            (3.0, 7.0, "premium", "workers")
        assert s.attrs == {"batch": "4"}

    def test_span_ids_unique_and_ordered(self):
        obs.enable(fresh=True)
        for _ in range(5):
            with obs.span("x"):
                pass
        sids = [s.sid for s in obs.session().recorder.spans]
        assert sids == sorted(sids) and len(set(sids)) == 5


class _Event:
    """A stand-in for a CUDA timing event: a device time in ms that has or
    has not run yet."""

    def __init__(self, t_ms, done=False):
        self.t, self.done, self.waited = t_ms, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


class TestDeferredSpans:
    def test_close_in_launch_order_once_their_events_ran(self):
        """A deferred span keeps the parent it had at launch; a later
        launch closes those whose stop event ran (without waiting), a read
        waits for the rest.  Under a SettableClock a span starts at the
        session clock at launch and lasts the events' time."""
        clock = obs.SettableClock(5.0)
        obs.enable(fresh=True, clock=clock)
        rec = obs.session().recorder
        a, b = (_Event(0.0), _Event(2.0)), (_Event(3.0), _Event(7.0))
        with obs.span("request") as req:
            rec.defer("kernel.a", *a, "card", lane="kernels")
            clock.set(6.0)
            rec.defer("kernel.b", *b, "card", lane="kernels")
        assert len(rec._pending) == 2
        a[1].done = True
        rec.defer("kernel.c", _Event(8.0, True), _Event(9.0, True), "card")
        assert [p.name for p in rec._pending] == ["kernel.b", "kernel.c"]
        assert not a[1].waited and not b[1].waited
        spans = {s.name: s for s in rec.spans}
        assert b[1].waited and not rec._pending
        assert (spans["kernel.a"].start_s, spans["kernel.a"].end_s) == (5.0, 5.002)
        assert spans["kernel.b"].start_s == 6.0
        assert spans["kernel.b"].duration_s == pytest.approx(0.004)
        assert spans["kernel.a"].parent == spans["kernel.b"].parent == req.sid
        assert spans["kernel.c"].parent is None
        assert spans["kernel.a"].lane == "kernels"
        assert spans["kernel.a"].sid < spans["kernel.b"].sid < spans["kernel.c"].sid

    def test_monotonic_clock_places_spans_where_the_card_ran_them(self, monkeypatch):
        """Under the monotonic clock a span starts at the anchor's host time
        plus the device time from the anchor event to its start event."""
        obs.enable(fresh=True)
        rec = obs.session().recorder
        anchors = []
        monkeypatch.setattr(rec, "anchor", lambda device: (
            anchors.append(device) or (_Event(100.0, True), 50.0)))
        rec.defer("kernel.a", _Event(350.0, True), _Event(351.5, True), "card")
        (s,) = rec.by_name("kernel.a")
        assert anchors == ["card"]
        assert s.start_s == pytest.approx(50.25)
        assert s.duration_s == pytest.approx(0.0015)

    def test_a_read_waits_for_the_card_outside_the_lock(self):
        """While a read waits for a stop event, the recorder's lock is free
        (other threads open, close and emit spans), and a launch's own
        resolution finds nothing to do instead of waiting too: what it
        deferred closes at the next read."""
        obs.enable(fresh=True, clock=obs.SettableClock(0.0))
        rec = obs.session().recorder
        seen = []

        class Stop(_Event):
            def synchronize(self):
                seen.append(rec._lock.locked())
                rec.emit("host.other", 1.0, 2.0)
                rec.defer("kernel.b", _Event(4.0, True), _Event(5.0, True), "card")
                super().synchronize()

        rec.defer("kernel.a", _Event(0.0), Stop(3.0), "card")
        assert [s.name for s in rec.spans] == ["host.other", "kernel.a"]
        assert seen == [False]
        assert [s.name for s in rec.spans] == ["host.other", "kernel.a", "kernel.b"]
        assert not rec._pending


# -- metrics ------------------------------------------------------------------

class TestMetrics:
    def test_histogram_bucket_edges_are_le_inclusive(self):
        h = Histogram(edges=(1.0, 2.0, 5.0))
        for v in (0.5, 1.0, 1.5, 2.0, 5.0, 5.0001):
            h.observe(v)
        assert h.counts == [2, 2, 1, 1]
        assert h.cumulative() == ((1.0, 2), (2.0, 4), (5.0, 5),
                                  (math.inf, 6))
        assert h.count == 6
        assert h.sum == pytest.approx(0.5 + 1.0 + 1.5 + 2.0 + 5.0 + 5.0001)

    def test_histogram_rejects_unsorted_edges_and_rebucketing(self):
        with pytest.raises(ValueError, match="ascending"):
            Histogram(edges=(2.0, 1.0))
        reg = MetricsRegistry()
        reg.histogram("lat", buckets=(1.0, 2.0)).observe(0.5)
        with pytest.raises(ValueError, match="re-bucket"):
            reg.histogram("lat", buckets=(1.0, 3.0))

    def test_counter_monotone_and_totals(self):
        reg = MetricsRegistry()
        reg.counter("serve.shed", reason="rate_limited").inc()
        reg.counter("serve.shed", reason="queue_full").inc(2)
        with pytest.raises(ValueError):
            reg.counter("serve.shed", reason="queue_full").inc(-1)
        assert reg.total("serve.shed") == 3
        assert reg.value("serve.shed", reason="queue_full") == 2
        assert reg.value("serve.shed", reason="nope") is None
        assert reg.total("never.touched") == 0.0

    def test_name_bound_to_one_kind(self):
        reg = MetricsRegistry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already a counter"):
            reg.histogram("x")


# -- disabled-mode no-op ------------------------------------------------------

def _facade_problem(seed=3):
    rng = np.random.default_rng(seed)
    A = rng.integers(-4, 5, size=(16, 8)).astype(np.float64)
    B = rng.integers(-4, 5, size=(16, 6)).astype(np.float64)
    kw = dict(K=10, L=16 * 16 + 1, points="chebyshev")
    return A, B, kw


class TestDisabledNoOp:
    def test_conveniences_are_noops_while_disabled(self):
        assert not obs.enabled()
        obs.count("a.counter")
        obs.observe("a.hist", 1.0)
        obs.gauge("a.gauge", 2.0)
        assert obs.emit_span("x", 0.0, 1.0) is None
        assert obs.span("x") is obs.span("y")  # the shared NULL_SPAN
        with obs.span("x"):
            pass
        with pytest.raises(RuntimeError, match="disabled"):
            obs.session()

    def test_instrumented_facade_results_bit_identical(self):
        """The same coded matmuls with obs off vs on: identical bits,
        identical cache behaviour - instrumentation is observation only."""
        A, B, kw = _facade_problem()
        plan = make_plan("bec", 2, 2, 2, **kw)

        def serve():
            cm = CodedMatmul(plan, "fused", device="cpu")
            outs = [cm(A, B, erased=[1, 7]), cm(A, B),
                    cm(A, B, progress=np.r_[0.5, np.ones(9)], sub_tasks=2)]
            Y = cm.worker_stage(A, B)
            outs.append(cm.decode_stage(Y, (8, 6), erased=[0, 3]))
            outs.append(cm.with_backend("staged")(A, B, erased=[2]))
            return [o.numpy() for o in outs], cm.cache_info()

        off, info_off = serve()
        obs.enable(fresh=True)
        on, info_on = serve()
        for a, b in zip(off, on):
            assert a.tobytes() == b.tobytes()
            np.testing.assert_array_equal(a, A.T @ B)
        assert info_off == info_on
        assert obs.session().registry.total("runtime.executable.compile") > 0

    def test_span_id_for_works_with_obs_disabled(self):
        assert not obs.enabled()
        sid = span_id_for(11, "step.premium", 0)
        assert sid == span_id_for(11, "step.premium", 0)
        assert len(sid) == 16 and int(sid, 16) >= 0
        assert sid != span_id_for(11, "step.premium", 1)
        assert sid != span_id_for(12, "step.premium", 0)
        assert sid != span_id_for(11, "step.standard", 0)


# -- exporters ----------------------------------------------------------------

class TestExporters:
    def _spans(self):
        obs.enable(fresh=True)
        rec = obs.session().recorder
        rec.emit("serve.worker_stage", 0.0, 2.0, track="premium",
                 lane="workers", batch=0)
        rec.emit("serve.decode_stage", 2.0, 3.0, track="premium",
                 lane="decode", batch=0)
        rec.emit("serve.worker_stage", 2.5, 4.0, track="standard",
                 lane="workers", batch=1)
        return rec.spans

    def test_perfetto_schema(self):
        events = perfetto_events(self._spans())
        meta = [e for e in events if e["ph"] == "M"]
        slices = [e for e in events if e["ph"] == "X"]
        procs = {e["args"]["name"] for e in meta
                 if e["name"] == "process_name"}
        assert procs == {"premium", "standard"}
        threads = [(e["pid"], e["args"]["name"]) for e in meta
                   if e["name"] == "thread_name"]
        assert len(threads) == 3
        assert len(slices) == 3
        for ev in slices:
            assert set(ev) == {"ph", "name", "pid", "tid", "ts", "dur",
                               "args"}
        by = {(e["name"], e["args"]["batch"]): e for e in slices}
        ev = by[("serve.worker_stage", "0")]
        assert (ev["ts"], ev["dur"]) == (0.0, 2_000_000.0)

    def test_write_perfetto_loads_as_json(self, tmp_path):
        path = tmp_path / "t.json"
        write_perfetto(str(path), self._spans())
        doc = json.loads(path.read_text())
        assert doc["displayTimeUnit"] == "ms"
        assert any(e["ph"] == "X" for e in doc["traceEvents"])

    def test_failed_span_flagged_in_args(self):
        obs.enable(fresh=True)
        with pytest.raises(ValueError):
            with obs.span("bad"):
                raise ValueError
        (ev,) = [e for e in perfetto_events(obs.session().recorder.spans)
                 if e["ph"] == "X"]
        assert ev["args"]["error"] == "1"

    def test_prometheus_round_trip(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("runtime.executable.compile", kind="concrete").inc(3)
        reg.gauge("pool.size").set(12)
        h = reg.histogram("serve.latency_s", buckets=(1.0, 10.0),
                          slo_class="premium")
        h.observe(0.5)
        h.observe(1.0)
        h.observe(20.0)
        text = reg.to_prometheus()
        assert "# TYPE runtime_executable_compile counter" in text
        assert 'runtime_executable_compile{kind="concrete"} 3' in text
        assert "# TYPE serve_latency_s histogram" in text
        assert 'le="+Inf"' in text

        path = tmp_path / "m.prom"
        write_prometheus(str(path), reg)
        samples = parse_prometheus(path.read_text())
        assert samples["pool_size"] == [({}, 12.0)]
        buckets = {lab["le"]: v
                   for lab, v in samples["serve_latency_s_bucket"]}
        assert buckets == {"1.0": 2.0, "10.0": 2.0, "+Inf": 3.0}
        assert samples["serve_latency_s_count"] == \
            [({"slo_class": "premium"}, 3.0)]

    def test_parse_rejects_garbage(self):
        with pytest.raises(ValueError, match="unparseable"):
            parse_prometheus("not a metric line at all!")


# -- obs_report ---------------------------------------------------------------

_GOLDEN_PERFETTO = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1,
     "args": {"name": "premium"}},
    {"ph": "X", "name": "serve.worker_stage", "pid": 1, "tid": 1,
     "ts": 0.0, "dur": 2_000_000.0, "args": {}},
    {"ph": "X", "name": "serve.worker_stage", "pid": 1, "tid": 1,
     "ts": 2.5e6, "dur": 1_500_000.0, "args": {}},
    {"ph": "X", "name": "serve.decode_stage", "pid": 1, "tid": 2,
     "ts": 2e6, "dur": 1_000_000.0, "args": {}},
]}


def _golden_registry():
    reg = MetricsRegistry()
    reg.counter("runtime.executable.hit", kind="concrete").inc(9)
    reg.counter("runtime.executable.compile", kind="concrete").inc(3)
    reg.counter("serve.admit", tenant="gold").inc(5)
    reg.counter("serve.shed", reason="rate_limited", tenant="free").inc(2)
    h = reg.histogram("serve.stage.worker_s", buckets=(1.0, 5.0), rung="bec")
    for v in (0.5, 0.75, 4.0):
        h.observe(v)
    return reg


class TestReport:
    def test_render_golden(self):
        """The full report for a fixed dump pair, golden-checked (the same
        expected text as the reference package's test)."""
        expected = (
            "== top spans (by total time, top 10) ==\n"
            "  serve.worker_stage: n=2 total=3.5s mean=1.75s\n"
            "  serve.decode_stage: n=1 total=1s mean=1s\n"
            "== cache hit ratios ==\n"
            "  runtime.executable: 9 hit / 3 other = 75.0%\n"
            "== admission ==\n"
            "  admitted = 5\n"
            "  shed = 2\n"
            "    reason=rate_limited,tenant=free: 2\n"
            "== latency histograms ==\n"
            "  serve_stage_worker_s{rung=bec}: n=3 mean=1.75s\n"
            "    le 1: 2\n"
            "    le 5: 1\n"
            "== counters ==\n"
            "  runtime_executable_compile{kind=concrete} = 3\n"
            "  runtime_executable_hit{kind=concrete} = 9\n"
            "  serve_admit{tenant=gold} = 5\n"
            "  serve_shed{reason=rate_limited,tenant=free} = 2\n"
        )
        assert render(_golden_registry().to_prometheus(),
                      _GOLDEN_PERFETTO) == expected

    def test_render_empty_dump(self):
        out = render("")
        assert "(no cache activity recorded)" in out
        assert "(no histograms recorded)" in out
        assert "shed = 0" in out

    def test_cli_prints_render_of_the_files(self, tmp_path, capsys):
        reg = _golden_registry()
        mpath, ppath = tmp_path / "m.prom", tmp_path / "t.json"
        write_prometheus(str(mpath), reg)
        ppath.write_text(json.dumps(_GOLDEN_PERFETTO))
        assert report_main(["--metrics", str(mpath), "--perfetto",
                            str(ppath), "--top", "1"]) == 0
        assert capsys.readouterr().out == render(
            reg.to_prometheus(), _GOLDEN_PERFETTO, top=1)


# -- parity with the JAX package ----------------------------------------------

def _drive(pkg):
    """One fixed call sequence into an obs package under a SettableClock."""
    clock = pkg.SettableClock(1.0)
    pkg.enable(fresh=True, clock=clock)
    with pkg.span("request", track="premium", tenant="gold"):
        clock.set(1.25)
        with pkg.span("runtime.executable.build", kind="concrete",
                      backend="fused"):
            clock.set(1.5)
        pkg.emit_span("serve.worker_stage", 1.5, 2.75, track="premium",
                      lane="workers", batch=0)
        pkg.count("runtime.executable.compile", kind="concrete")
        pkg.count("runtime.executable.hit", 3, kind="concrete")
        pkg.count("decode.panel_cache.miss", cache="panel")
        pkg.count("serve.shed", reason='quo"te\\d', tenant="free")
        pkg.gauge("pool.size", 12)
        pkg.gauge("pool.load", 0.375)
        for v in (0.0005, 0.02, 0.02, 3.0, 500.0):
            pkg.observe("serve.latency_s", v, slo_class="premium")
        pkg.observe("serve.stage.worker_s", 0.5, buckets=(0.25, 1.0),
                    rung="bec")
        clock.set(3.0)
    with pytest.raises(KeyError):
        with pkg.span("failing", lane="decode"):
            clock.set(3.5)
            raise KeyError("x")
    s = pkg.session()
    return s.recorder.spans, s.registry


def test_same_calls_give_identical_exports_and_report():
    spans, reg = _drive(obs)
    jspans, jreg = _drive(jobs)
    events = perfetto_events(spans)
    assert events == jperfetto_events(jspans)
    assert len([e for e in events if e["ph"] == "X"]) == 4
    text = reg.to_prometheus()
    assert text == jreg.to_prometheus()
    doc = {"traceEvents": events}
    assert render(text, doc) == jrender(text, doc)
    assert render(text, doc, top=2) == jrender(text, doc, top=2)
    assert parse_prometheus(text)["pool_load"] == [({}, 0.375)]


@settings(max_examples=200, deadline=None)
@given(seed=st.integers(-2**63, 2**63), kind=st.text(max_size=24),
       index=st.integers(-2**31, 2**40))
def test_span_id_for_equals_reference(seed, kind, index):
    assert span_id_for(seed, kind, index) == jspan_id_for(seed, kind, index)


_COUNTERS = ("runtime.executable.compile", "runtime.executable.hit",
             "decode.panel_cache.miss", "decode.panel_cache.hit")
_PATTERNS = ([0, 2, 4, 6, 8, 9], [1], [], [3, 7])


def _facade_run(cm, A, B, to_host):
    """Four binary patterns twice, one partial request and one split-stage
    request, all on one facade."""
    outs = []
    for _ in range(2):
        for erased in _PATTERNS:
            outs.append(to_host(cm(A, B, erased=erased)))
    outs.append(to_host(cm(A, B, progress=np.r_[0.5, 0.75, np.ones(8)],
                           sub_tasks=2)))
    Y = cm.worker_stage(A, B)
    outs.append(to_host(cm.decode_stage(Y, (A.shape[1], B.shape[1]),
                                        erased=[5])))
    return outs


def _counter_table(registry):
    return {(name, labels): m.value
            for (name, labels), m in registry.collect()
            if name in _COUNTERS}


def test_facade_counters_match_reference():
    """The port's facade and the JAX facade, driven through the same
    calls, count the same pipeline builds/hits and panel misses/hits and
    end with the same executable_cache_size."""
    A, B, kw = _facade_problem(5)
    jcm = JCodedMatmul(jmake_plan("bec", 2, 2, 2, **kw), "fused")
    cm = CodedMatmul(make_plan("bec", 2, 2, 2, **kw), "fused", device="cpu")

    jobs.enable(fresh=True)
    jouts = _facade_run(jcm, jnp.asarray(A), jnp.asarray(B), np.asarray)
    obs.enable(fresh=True)
    outs = _facade_run(cm, A, B, lambda x: x.numpy())

    for a, b in zip(outs, jouts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, A.T @ B)
    table = _counter_table(obs.session().registry)
    assert table == _counter_table(jobs.session().registry)
    reg = obs.session().registry
    assert reg.value("runtime.executable.compile", kind="concrete") == 1
    assert reg.value("decode.panel_cache.miss", cache="panel") == 6
    assert cm.executable_cache_size() == jcm.executable_cache_size() == 4
    for name in ("runtime.executable.build", "decode.panel.build"):
        assert (len(obs.session().recorder.by_name(name))
                == len(jobs.session().recorder.by_name(name)))


def test_executable_cache_size_flat_across_patterns():
    A, B, kw = _facade_problem(6)
    cm = CodedMatmul(make_plan("bec", 2, 2, 2, **kw), device="cpu")
    assert cm.executable_cache_size() == 0
    cm(A, B)
    assert cm.executable_cache_size() == 1
    for erased in _PATTERNS:
        cm(A, B, erased=erased)
    assert cm.executable_cache_size() == 1
    sibling = cm.with_backend("reference")
    sibling(A, B)
    assert cm.executable_cache_size() == sibling.executable_cache_size() == 2


# -- spans at the facade's layer boundaries -----------------------------------

_CALLS = {
    "concrete": lambda cm, A, B: cm(A, B, erased=[1, 7]),
    "partial": lambda cm, A, B: cm(A, B, progress=np.r_[0.5, np.ones(9)], sub_tasks=2),
}
_UPLOADS = {"concrete": ("mask", "panel"), "partial": ("chunk_masks", "panel_stack")}


def _warm_facade(kind):
    A, B, kw = _facade_problem(8)
    cm = CodedMatmul(make_plan("bec", 2, 2, 2, **kw), "fused", device="cpu")
    _CALLS[kind](cm, A, B)               # builds the pipeline and the panel
    return cm, A, B


@pytest.mark.parametrize("kind", sorted(_CALLS))
def test_a_call_records_its_span_tree(kind):
    """``runtime.call`` holds ``runtime.prepare`` (with the panel lookup and
    the two uploads), then ``stage.worker`` and ``stage.decode``, each
    holding its kernel; the uploads count ``runtime.upload{what}`` once
    each."""
    cm, A, B = _warm_facade(kind)
    obs.enable(fresh=True)
    C = _CALLS[kind](cm, A, B)
    np.testing.assert_array_equal(C.numpy(), A.T @ B)
    spans = obs.session().recorder.spans
    by = {s.sid: s for s in spans}

    def named(name):
        return [s for s in spans if s.name == name]

    (call,) = named("runtime.call")
    (prep,) = named("runtime.prepare")
    assert call.parent is None and prep.parent == call.sid
    assert call.attrs == {"kind": "partial" if kind == "partial" else "binary",
                          "Q": "2" if kind == "partial" else "1"}
    gets, uploads = named("decode.panel.get"), named("runtime.upload")
    assert gets and gets[-1].parent == prep.sid           # the outermost lookup
    assert all(by[g.parent].name in ("runtime.prepare", "decode.panel.get") for g in gets)
    assert [u.attrs["what"] for u in uploads] == list(_UPLOADS[kind])
    assert all(u.parent == prep.sid for u in uploads)
    for stage, op in (("stage.worker", "fused_worker"),
                      ("stage.decode", "decode_partial" if kind == "partial" else "decode")):
        (st,) = named(stage)
        assert st.parent == call.sid and st.start_s >= prep.end_s
        (k,) = named(f"kernel.{op}")
        assert k.parent == st.sid
    for s in spans:                      # every chain ends at the call
        while s.parent is not None:
            s = by[s.parent]
        assert s is call
    reg = obs.session().registry
    assert reg.total("runtime.upload") == 2
    assert all(reg.value("runtime.upload", what=w) == 1 for w in _UPLOADS[kind])


def _host_ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("kind", sorted(_CALLS))
def test_spans_reach_the_profiler_as_nested_ranges(kind, collect):
    """Under a recording ``torch.profiler`` the facade's spans are host
    ranges of the same names, nested as the spans are, obs on or off."""
    from torch.profiler import ProfilerActivity, profile

    cm, A, B = _warm_facade(kind)
    if collect:
        obs.enable(fresh=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _CALLS[kind](cm, A, B)
    ranges = _host_ranges(prof)

    def one(name):
        (r,) = [r for r in ranges if r[0] == name]
        return r

    def inside(inner, outer):
        return outer[1] <= inner[1] and inner[2] <= outer[2]

    call, prep = one("runtime.call"), one("runtime.prepare")
    assert inside(prep, call)
    gets = [r for r in ranges if r[0] == "decode.panel.get"]
    uploads = [r for r in ranges if r[0] == "runtime.upload"]
    assert gets and len(uploads) == 2
    assert all(inside(r, prep) for r in gets + uploads)
    for stage in ("stage.worker", "stage.decode"):
        st = one(stage)
        assert inside(st, call) and st[1] >= prep[2]
    assert obs.enabled() == collect


def test_spans_enter_no_profiler_range_unless_one_records(monkeypatch):
    """Obs on and no profiler: no profiler range is entered; both off: the
    shared ``NULL_SPAN``; a profiler alone: a range, not NULL_SPAN."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.spans import NULL_SPAN

    cm, A, B = _warm_facade("concrete")
    assert obs.span("runtime.call") is NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.span("runtime.call") is not NULL_SPAN

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    obs.enable(fresh=True)
    _CALLS["concrete"](cm, A, B)
    assert len(obs.session().recorder.by_name("runtime.call")) == 1
    obs.disable()
    assert obs.span("runtime.call") is NULL_SPAN


# -- the kernel hook ----------------------------------------------------------

def _seven_calls(device="cpu"):
    """One small call of each public wrapper: ``{op: thunk}``."""
    g = torch.Generator().manual_seed(7)

    def t(*shape, dtype=torch.float64):
        return torch.randn(shape, generator=g, dtype=dtype).to(device)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=g).to(device, torch.float64)

    ca, cb, a, b = t(4, 4), t(4, 2), t(4, 16, 8), t(2, 16, 6)
    W, Y, Ws, Ys = ints(4, 10), ints(10, 12), ints(2, 4, 10), ints(2, 10, 6)
    coeff, blocks = t(5, 3), t(3, 20)
    A, Bm = t(16, 8), t(16, 6)
    f32 = dict(dtype=torch.float32)
    w = torch.exp(-torch.exp(t(1, 8, 2, 8, **f32)))
    k, r, v, u = t(1, 8, 2, 8, **f32), t(1, 8, 2, 8, **f32), \
        t(1, 8, 2, 8, **f32), t(2, 8, **f32)
    dt = torch.nn.functional.softplus(t(1, 8, 4, **f32))
    x, Bs, Cs = t(1, 8, 4, **f32), t(1, 8, 2, **f32), t(1, 8, 2, **f32)
    A_log, D = t(4, 2, **f32).abs() + 0.1, t(4, **f32)
    return {
        "fused_worker": lambda: ops.fused_worker(ca, cb, a, b),
        "decode": lambda: ops.decode(W, Y, 64.0),
        "decode_partial": lambda: ops.decode_partial(Ws, Ys, 64.0),
        "encode": lambda: ops.encode(coeff, blocks),
        "matmul_t": lambda: ops.matmul_t(A, Bm),
        "wkv_scan": lambda: ops.wkv_scan(w, k, v, r, u, chunk=4),
        "mamba_scan": lambda: ops.mamba_scan(dt, x, Bs, Cs, A_log, D, chunk=4),
    }


def _flat(out):
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def test_kernel_hook_is_free_while_obs_is_off(monkeypatch):
    """Obs off: each wrapper returns what the undecorated function returns,
    bit for bit, with the same launch counts, and makes no CUDA event and
    no synchronize."""
    def refuse(*args, **kwargs):
        raise AssertionError("the hook touched CUDA while obs was off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    calls = _seven_calls()
    ops.reset_launch_counts()
    for op, call in calls.items():
        hooked = getattr(ops, op)
        wrapped = _flat(call())
        counts = ops.launch_counts()
        setattr(ops, op, hooked.__wrapped__)
        try:
            unwrapped = _flat(call())
        finally:
            setattr(ops, op, hooked)
        assert ops.launch_counts() == counts
        for a, b in zip(wrapped, unwrapped):
            assert a.tobytes() == b.tobytes(), op
    assert not obs.enabled()
    assert all(n == 0 for n in ops.launch_counts().values())


def test_kernel_hook_counts_and_spans_every_call():
    """Obs on, CPU tensors: ``kernel.call{op, traced=0}`` once per call and
    one ``kernel.<op>`` span on lane ``kernels`` bracketed by the session
    clock; results unchanged."""
    calls = _seven_calls()
    off = {op: _flat(call()) for op, call in calls.items()}
    obs.enable(fresh=True)
    for _ in range(2):
        for op, call in calls.items():
            for a, b in zip(_flat(call()), off[op]):
                assert a.tobytes() == b.tobytes(), op
    reg, rec = obs.session().registry, obs.session().recorder
    for op in calls:
        assert reg.value("kernel.call", op=op, traced=0) == 2, op
        spans = rec.by_name(f"kernel.{op}")
        assert len(spans) == 2 and all(s.lane == "kernels" for s in spans)
        assert all(s.end_s >= s.start_s for s in spans)
    assert reg.total("kernel.call") == 2 * len(calls)


def test_compile_watch_gates_rebuilds():
    """``benchmarks/torch_obs_util.py`` reads the facade's compile counter:
    flat across new erasure patterns after a prewarm, and a rebuild (a new
    operand shape) trips the gate."""
    from benchmarks.torch_obs_util import CompileWatch, assert_no_recompiles

    A, B, kw = _facade_problem(7)
    cm = CodedMatmul(make_plan("bec", 2, 2, 2, **kw), device="cpu")
    watch = CompileWatch(fresh=True)
    assert obs.enabled() and watch.compiles() == 0
    cm(A, B)
    assert watch.mark() == 1
    for erased in _PATTERNS:
        cm(A, B, erased=erased)
    assert_no_recompiles(watch.delta(), "patterns")
    cm(A[:, :4], B)
    assert watch.delta() == 1
    with pytest.raises(AssertionError, match="1 executable recompile"):
        assert_no_recompiles(watch.delta(), "a new shape")
