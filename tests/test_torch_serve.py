"""The port's multi-tenant serve tier (``repro_torch.serve``) on the CPU.

Mirrors ``tests/test_serve.py``'s admission, batching, pipeline, floor
policy, spec parsing, tier, trace and golden cases on ``device="cpu"`` (the
plain PyTorch versions), then holds the port against the JAX package: the
checked-in golden serve trace replays diff-free on every backend, and a
JAX ``ServeTier`` and the port's, fed the same numpy operands and the same
scenario, give identical ``ServeTrace``s (floats to the last bit) and
products equal element for element, also where the entry bound makes bec
infeasible and the premium class's rung floor clamps the policy.
"""
import dataclasses
from collections import deque
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.chaos import make_scenario  # noqa: E402
from repro_torch.control import PlanLadder, QuantileLatencyPolicy  # noqa: E402
from repro_torch.core.simulator import LatencyModel  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    GOLDEN_SERVE_SCENARIO,
    REJECT_QUEUE_FULL,
    REJECT_RATE_LIMITED,
    AdmissionController,
    ContinuousBatcher,
    Request,
    RungFloorPolicy,
    ServeTier,
    ServeTrace,
    SLOClass,
    TenantSpec,
    TokenBucket,
    TwoStagePipeline,
    golden_serve_result,
    golden_serve_trace,
    parse_tenant_spec,
)
from repro_torch.serve.trace import golden_operands  # noqa: E402

K = 12
GRID = (4, 2, 1)
L = 257
L_BEC_INFEASIBLE = 1 << 14
SHAPES = ((16, 8), (16, 4))
OVERHEAD = {"bec": 2.0, "tradeoff(p'=2)": 1.0, "polycode": 0.1}
GOLDEN_DIR = Path(__file__).parent / "golden"
CPU = "cpu"


@pytest.fixture(autouse=True)
def _obs_off():
    """A tier run installs its simulated clock in the obs session: leave
    obs off for the next test."""
    yield
    obs.disable()


@pytest.fixture(scope="module")
def ladder():
    """One prewarmed ladder shared by every tier test in this module."""
    lad = PlanLadder(*GRID, K=K, L=L, backend="reference", device=CPU)
    lad.prewarm(*SHAPES, batch_sizes=(2, 4), stages=True)
    return lad


def _req(rid, tenant="a", cls="c", arrival=0.0, deadline=10.0):
    return Request(rid=rid, tenant=tenant, slo_class=cls,
                   arrival_s=arrival, deadline_s=deadline)


class TestTokenBucket:
    def test_starts_full_and_caps_at_burst(self):
        b = TokenBucket(rate_rps=1.0, burst=2)
        assert b.take(0.0) and b.take(0.0)
        assert not b.take(0.0)          # drained
        assert b.take(100.0)            # refilled, but capped at burst
        assert b.take(100.0)
        assert not b.take(100.0)

    def test_refills_at_rate(self):
        b = TokenBucket(rate_rps=0.5, burst=1)
        assert b.take(0.0)
        assert not b.take(1.0)          # only 0.5 tokens back
        assert b.take(2.0)              # one full token after 2 s

    def test_infinite_rate_always_admits(self):
        b = TokenBucket(rate_rps=float("inf"), burst=1)
        assert all(b.take(0.0) for _ in range(50))


class TestAdmission:
    def _ctrl(self, rate=1.0, burst=2, max_queue=2):
        spec = TenantSpec(name="a", slo_class="c", rate_rps=rate,
                          burst=burst, max_queue=max_queue)
        return AdmissionController({"a": spec})

    def test_rate_limited_reason(self):
        ctrl = self._ctrl(rate=0.1, burst=1, max_queue=8)
        assert ctrl.offer(_req(0), 0.0) is None
        assert ctrl.offer(_req(1), 0.0) == REJECT_RATE_LIMITED
        assert ctrl.queued() == 1

    def test_queue_full_reason(self):
        ctrl = self._ctrl(rate=float("inf"), max_queue=2)
        assert ctrl.offer(_req(0), 0.0) is None
        assert ctrl.offer(_req(1), 0.0) is None
        assert ctrl.offer(_req(2), 0.0) == REJECT_QUEUE_FULL
        assert ctrl.queued() == 2

    def test_unknown_tenant_raises(self):
        with pytest.raises(KeyError):
            self._ctrl().offer(_req(0, tenant="nobody"), 0.0)


class TestBatcher:
    def _queues(self, *reqs):
        out = {}
        for r in reqs:
            out.setdefault(r.tenant, deque()).append(r)
        return out

    def test_earliest_deadline_class_wins(self):
        b = ContinuousBatcher({"a": "fast", "b": "slow"}, max_batch=4)
        queues = self._queues(
            _req(0, tenant="b", cls="slow", arrival=0.0, deadline=60.0),
            _req(1, tenant="a", cls="fast", arrival=1.0, deadline=5.0))
        batch = b.form(queues)
        assert batch.slo_class == "fast"
        assert [r.rid for r in batch.requests] == [1]
        # the slow request is still queued for the next step
        assert b.form(queues).slo_class == "slow"
        assert b.form(queues) is None

    def test_coalesces_across_tenants_and_caps(self):
        b = ContinuousBatcher({"a": "c", "b": "c"}, max_batch=2)
        queues = self._queues(
            _req(0, tenant="a", deadline=9.0),
            _req(1, tenant="b", deadline=7.0),
            _req(2, tenant="a", deadline=8.0))
        batch = b.form(queues)
        # EDF order across BOTH tenant queues, capped at max_batch
        assert [r.rid for r in batch.requests] == [1, 2]
        assert [r.rid for r in queues["a"]] == [0]
        assert not queues["b"]

    def test_empty_returns_none(self):
        b = ContinuousBatcher({"a": "c"}, max_batch=4)
        assert b.form(self._queues()) is None

    def test_bad_max_batch_raises(self):
        with pytest.raises(ValueError):
            ContinuousBatcher({}, max_batch=0)


class TestTwoStagePipeline:
    def test_pipelined_overlaps_decode(self):
        pipe = TwoStagePipeline(pipelined=True)
        first = pipe.schedule(0.0, worker_s=3.0, decode_s=2.0)
        assert (first.compute_done_s, first.decode_done_s) == (3.0, 5.0)
        # the next batch's workers start while the decoder drains batch 1
        assert pipe.next_free_s == 3.0
        second = pipe.schedule(3.0, worker_s=1.0, decode_s=2.0)
        assert second.compute_start_s == 3.0
        # decode of batch 2 queues behind the busy decoder
        assert second.decode_start_s == 5.0
        assert second.decode_done_s == 7.0

    def test_serial_holds_both_resources(self):
        pipe = TwoStagePipeline(pipelined=False)
        first = pipe.schedule(0.0, worker_s=3.0, decode_s=2.0)
        assert pipe.next_free_s == 5.0
        second = pipe.schedule(0.0, worker_s=1.0, decode_s=2.0)
        assert second.compute_start_s == first.decode_done_s == 5.0
        assert second.decode_done_s == 8.0

    def test_idle_pipeline_starts_at_now(self):
        pipe = TwoStagePipeline()
        t = pipe.schedule(7.5, worker_s=1.0, decode_s=0.5)
        assert t.compute_start_s == 7.5 and t.decode_done_s == 9.0


class TestRungFloorPolicy:
    def _model(self):
        return LatencyModel(base=np.ones(K), straggler_slowdown=2.0,
                            jitter=np.full(K, 0.02))

    def test_floor_clamps_thin_budget_winner(self, ladder):
        # overheads make polycode (budget 1) the ranked winner ...
        base = QuantileLatencyPolicy(ladder, q=0.9, overhead_s=OVERHEAD)
        assert base.select(self._model()).rung == "polycode"
        # ... but the floor refuses anything thinner than tradeoff
        floored = RungFloorPolicy(ladder, q=0.9, overhead_s=OVERHEAD,
                                  floor="tradeoff(p'=2)")
        pick = floored.select(self._model())
        assert pick.rung == "tradeoff(p'=2)"
        assert ladder.budget(pick.rung) >= ladder.budget("tradeoff(p'=2)")

    def test_no_floor_is_base_policy(self, ladder):
        base = QuantileLatencyPolicy(ladder, q=0.9, overhead_s=OVERHEAD)
        free = RungFloorPolicy(ladder, q=0.9, overhead_s=OVERHEAD)
        assert free.select(self._model()).rung == \
            base.select(self._model()).rung

    def test_wide_budget_winner_passes_through(self, ladder):
        # zero overheads rank by completion alone -> bec (budget 10) wins
        zero = {r: 0.0 for r in ladder.rungs}
        floored = RungFloorPolicy(ladder, q=0.9, overhead_s=zero,
                                  floor="tradeoff(p'=2)")
        assert floored.select(self._model()).rung == "bec"

    def test_unknown_floor_raises(self, ladder):
        with pytest.raises(KeyError):
            RungFloorPolicy(ladder, floor="nonesuch", overhead_s=OVERHEAD)

    def test_infeasible_bec_never_served_under_the_floor(self):
        """Where the entry bound makes bec infeasible, the ranked winner
        and the clamp stay on feasible rungs (zero overheads would rank
        bec first)."""
        lad = PlanLadder(*GRID, K=K, L=L_BEC_INFEASIBLE, device=CPU)
        assert not lad.feasible("bec")
        zero = {r: 0.0 for r in lad.rungs}
        floored = RungFloorPolicy(lad, q=0.9, overhead_s=zero,
                                  floor="tradeoff(p'=2)")
        assert floored.select(self._model()).rung == "tradeoff(p'=2)"
        floored = RungFloorPolicy(lad, q=0.9, overhead_s=OVERHEAD,
                                  floor="tradeoff(p'=2)")
        assert floored.select(self._model()).rung == "tradeoff(p'=2)"


class TestTenantSpecParsing:
    def test_json_string_round_trip(self):
        spec = ('{"classes": [{"name": "c", "slo_s": 5.0}], '
                '"tenants": [{"name": "a", "slo_class": "c"}]}')
        classes, tenants = parse_tenant_spec(spec)
        assert classes["c"].slo_s == 5.0
        assert tenants["a"].slo_class == "c"

    def test_sequence_defaults_classes(self):
        classes, tenants = parse_tenant_spec(
            [{"name": "a", "slo_class": "premium"}])
        assert "premium" in classes and tenants["a"].slo_class == "premium"

    def test_duplicate_and_unknown_raise(self):
        with pytest.raises(ValueError, match="duplicate"):
            parse_tenant_spec({"classes": [{"name": "c"}, {"name": "c"}],
                               "tenants": [{"name": "a", "slo_class": "c"}]})
        with pytest.raises(ValueError, match="unknown SLO class"):
            parse_tenant_spec({"classes": [{"name": "c"}],
                               "tenants": [{"name": "a", "slo_class": "x"}]})

    def test_validation(self):
        with pytest.raises(ValueError):
            SLOClass(name="c", quantile=1.5)
        with pytest.raises(ValueError):
            TenantSpec(name="a", slo_class="c", max_queue=0)


def _small_tier(ladder, **kw):
    classes = (SLOClass(name="premium", quantile=0.99, slo_s=12.0,
                        rung_floor="tradeoff(p'=2)"),
               SLOClass(name="standard", quantile=0.9, slo_s=60.0))
    tenants = (TenantSpec(name="gold", slo_class="premium", arrival_rps=1.0),
               TenantSpec(name="free", slo_class="standard", arrival_rps=2.0,
                          rate_rps=0.5, burst=2, max_queue=3))
    feed = make_scenario("heavy_tail").compile(K, seed=5)
    defaults = dict(classes=classes, tenants=tenants, feed=feed,
                    overhead_s=OVERHEAD, seed=5, check_exact=True,
                    keep_results=True)
    defaults.update(kw)
    return ServeTier(ladder, **defaults)


def _payload(rid):
    base = np.arange(SHAPES[0][0] * SHAPES[0][1]).reshape(SHAPES[0])
    return torch.as_tensor((base * (rid + 3)) % 11 - 5, dtype=torch.float64)


def _run_small(ladder, **kw):
    ladder.switch(ladder.rungs[0])  # order-independent under the shared fixture
    tier = _small_tier(ladder, **kw)
    B = torch.as_tensor(np.arange(SHAPES[1][0] * SHAPES[1][1])
                        .reshape(SHAPES[1]) % 7 - 3, dtype=torch.float64)
    return tier.run(lambda req: _payload(req.rid), B, 8), B


class TestServeTier:
    def test_every_request_accounted(self, ladder):
        result, _ = _run_small(ladder)
        assert len(result.requests) == 16
        assert len(result.admitted) + len(result.shed) == 16
        assert len(result.completed) == len(result.admitted)
        for rec in result.shed:
            assert rec.reject_reason in (REJECT_RATE_LIMITED,
                                         REJECT_QUEUE_FULL)
        # the overloaded free tenant actually sheds
        assert any(r.tenant == "free" for r in result.shed)

    def test_deterministic_replay(self, ladder):
        r1, _ = _run_small(ladder)
        r2, _ = _run_small(ladder)
        t1, t2 = ServeTrace.from_result(r1), ServeTrace.from_result(r2)
        assert t1.diff(t2) == []

    def test_results_bit_identical_to_facade(self, ladder):
        result, B = _run_small(ladder)
        cm = ladder.facade(ladder.rungs[0])
        for rec in result.completed:
            C = result.results[rec.rid]
            assert C.device.type == CPU and C.shape == (8, 4)
            assert torch.equal(C, cm(_payload(rec.rid), B))

    def test_latency_bookkeeping(self, ladder):
        result, _ = _run_small(ladder)
        for rec in result.completed:
            assert rec.queue_delay_s >= -1e-9
            assert rec.latency_s == pytest.approx(
                rec.completion_s - rec.arrival_s)
            assert rec.violated == (rec.latency_s > rec.slo_s)
        for b in result.batches:
            assert b.size <= 4 and b.size <= b.bucket
            assert b.report.get("exact") is True

    def test_pipeline_beats_serial_on_drain_time(self, ladder):
        fast, _ = _run_small(ladder)
        slow, _ = _run_small(ladder, pipelined=False, max_batch=1)
        assert fast.throughput_rps() > slow.throughput_rps()

    def test_rerun_raises(self, ladder):
        tier = _small_tier(ladder)
        B = torch.zeros(SHAPES[1], dtype=torch.float64)
        tier.run(lambda req: _payload(req.rid), B, 2)
        with pytest.raises(RuntimeError, match="fresh tier"):
            tier.run(lambda req: _payload(req.rid), B, 2)

    def test_split_stages_needs_single_sub_task(self, ladder):
        with pytest.raises(ValueError, match="sub_tasks"):
            _small_tier(ladder, sub_tasks=2, split_stages=True)

    def test_unknown_class_raises(self, ladder):
        with pytest.raises(ValueError, match="unknown SLO class"):
            ServeTier(ladder,
                      classes=(SLOClass(name="c"),),
                      tenants=(TenantSpec(name="a", slo_class="nope"),))

    def test_results_kept_only_when_asked(self, ladder):
        result, _ = _run_small(ladder, keep_results=False)
        assert result.results is None and result.completed


class TestServeTrace:
    def test_save_load_round_trip(self, ladder, tmp_path):
        result, _ = _run_small(ladder)
        trace = ServeTrace.from_result(result)
        loaded = ServeTrace.load(trace.save(tmp_path / "t.jsonl"))
        assert loaded.diff(trace) == []
        assert loaded.meta == trace.meta

    def test_diff_catches_drift(self, ladder):
        result, _ = _run_small(ladder)
        trace = ServeTrace.from_result(result)
        mutated = list(trace.requests)
        mutated[0] = dict(mutated[0], latency_s=999.0)
        drifted = dataclasses.replace(trace, requests=tuple(mutated))
        assert any("latency_s" in line for line in trace.diff(drifted))

    def test_load_rejects_foreign_files(self, tmp_path):
        bad = tmp_path / "bad.jsonl"
        bad.write_text('{"kind": "nonsense"}\n')
        with pytest.raises(ValueError, match="header"):
            ServeTrace.load(bad)
        bad.write_text('{"kind": "header", "version": 99}\n')
        with pytest.raises(ValueError, match="version"):
            ServeTrace.load(bad)


class TestGoldenServeTrace:
    """The checked-in recording (written by the JAX package's recipe) against
    the port's run of the same recipe, on every local backend."""

    @pytest.mark.parametrize("backend", ["reference", "fused", "staged"])
    def test_golden_serve_replays_bit_exactly(self, backend):
        recorded = ServeTrace.load(
            GOLDEN_DIR / f"serve_{GOLDEN_SERVE_SCENARIO}.jsonl")
        fresh = golden_serve_trace(device=CPU, backend=backend)
        drift = fresh.diff(recorded)
        assert drift == [], "\n".join(drift[:20])
        assert fresh.meta == recorded.meta
        # the recording must actually exercise the tier: batching,
        # shedding, and both SLO classes (otherwise the replay is vacuous)
        sizes = {b["size"] for b in recorded.batches}
        assert any(s > 1 for s in sizes)
        assert any(not r["admitted"] for r in recorded.requests)
        assert {b["slo_class"] for b in recorded.batches} == \
            {"premium", "standard"}

    def test_golden_products_exact_and_on_the_device(self):
        result = golden_serve_result(device=CPU)
        make_A, B = golden_operands(CPU)
        assert len(result.results) == len(result.completed) > 0
        for rec in result.completed:
            A = make_A(rec)
            assert torch.equal(result.results[rec.rid], A.T @ B)

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            golden_serve_result()


# -- the port against the JAX package -----------------------------------------

SPEC = {
    "classes": [
        {"name": "premium", "quantile": 0.99, "slo_s": 12.0,
         "rung_floor": "tradeoff(p'=2)"},
        {"name": "standard", "quantile": 0.9, "slo_s": 120.0},
    ],
    "tenants": [
        {"name": "gold", "slo_class": "premium", "arrival_rps": 1.5},
        {"name": "silver", "slo_class": "standard", "arrival_rps": 1.0},
        {"name": "free", "slo_class": "standard", "arrival_rps": 2.5,
         "rate_rps": 0.5, "burst": 3, "max_queue": 6},
    ],
}
BUCKETS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def ladders():
    """L -> (JAX ladder, port ladder), prewarmed alike, built on first use."""
    from repro.control import PlanLadder as RefLadder

    built = {}

    def get(L_):
        if L_ not in built:
            ref = RefLadder(*GRID, K=K, L=L_, backend="reference")
            port = PlanLadder(*GRID, K=K, L=L_, backend="reference",
                              device=CPU)
            for lad in (ref, port):
                lad.prewarm(*SHAPES, batch_sizes=BUCKETS, stages=True)
            built[L_] = (ref, port)
        return built[L_]

    return get


def _tier_run(name, lad, scenario, operands, **kw):
    """One package's ServeTier over the bench SPEC; returns its result."""
    if name == "jax":
        from repro.chaos import make_scenario as mk
        from repro.serve import ServeTier as Tier
        from repro.serve import parse_tenant_spec as parse
        arr = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    else:
        mk, Tier, parse = make_scenario, ServeTier, parse_tenant_spec
        arr = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    A_pool, B = operands
    classes, tenants = parse(SPEC)
    lad.switch(next(r for r in lad.rungs if lad.feasible(r)))
    tier = Tier(lad, classes=tuple(classes.values()),
                tenants=tuple(tenants.values()),
                feed=mk(scenario).compile(K, seed=11), overhead_s=OVERHEAD,
                seed=11, check_exact=True, keep_results=True, **kw)
    return tier.run(lambda req: arr(A_pool[req.rid % len(A_pool)]), arr(B),
                    16)


def _operands(seed, entry):
    rng = np.random.default_rng(seed)
    return (rng.integers(-entry, entry + 1, size=(48,) + SHAPES[0]),
            rng.integers(-entry, entry + 1, size=SHAPES[1]))


class TestParityWithReference:
    @pytest.mark.parametrize("L_,scenario,kw", [
        (L, "heavy_tail", {}),
        (L, "pareto", {}),
        (L, "heavy_tail", {"pipelined": False, "max_batch": 1}),
        (L, "crawler", {"sub_tasks": 4}),
        (L_BEC_INFEASIBLE, "heavy_tail", {}),
        (L_BEC_INFEASIBLE, "pareto", {}),
    ])
    def test_traces_and_products_equal(self, ladders, L_, scenario, kw):
        ref_lad, port_lad = ladders(L_)
        operands = _operands(0, 4)
        if kw.get("sub_tasks"):
            for lad in (ref_lad, port_lad):
                lad.prewarm(*SHAPES, batch_sizes=BUCKETS, stages=True,
                            sub_tasks=kw["sub_tasks"])
        want = _tier_run("jax", ref_lad, scenario, operands, **kw)
        got = _tier_run("torch", port_lad, scenario, operands, **kw)
        t_got, t_want = ServeTrace.from_result(got), ServeTrace.from_result(want)
        assert t_got.diff(t_want) == [] and t_got.meta == t_want.meta
        assert got.tenant_stats() == want.tenant_stats()
        assert got.throughput_rps() == want.throughput_rps()
        assert set(got.results) == set(want.results)
        for rid, C in got.results.items():
            np.testing.assert_array_equal(C.numpy(), np.asarray(want.results[rid]))
        assert all(b.report["exact"] for b in got.batches)
        rungs = {(b.slo_class, b.rung) for b in got.batches}
        if L_ == L_BEC_INFEASIBLE:
            # the premium floor clamps polycode (the cheap winner) to
            # tradeoff, and nothing serves the infeasible bec
            assert ("premium", "tradeoff(p'=2)") in rungs
            assert not any(r == "bec" for _, r in rungs)
            assert not any(c == "premium" and r == "polycode"
                           for c, r in rungs)
