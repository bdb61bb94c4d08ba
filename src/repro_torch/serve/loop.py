"""The asynchronous multi-tenant serving loop over ``AdaptiveServer``.

``ServeTier`` composes the subsystem: per-tenant admission control
(``serve.admission``), continuous batching into prewarmed buckets
(``serve.batcher``), one ``AdaptiveServer`` PER SLO CLASS — each with its
own quantile, rung floor, and ``ViolationFeedback`` state, all sharing
ONE ``WorkerHealthMonitor`` and ONE ``PlanLadder`` — and a two-stage
pipeline that overlaps decode of step *t* with the worker stage of step
*t+1* through the facade's split entry points.

Everything advances on a SEEDED SIMULATED CLOCK: arrivals are inverse-CDF
Poisson streams keyed ``(seed, tenant index)``, worker times come from a
chaos ``TimeFeed`` consumed one step per DISPATCH (a shared counter, so
per-class servers interleave on one scenario stream), and stage latencies
are the control plane's own modelled costs (masked completion for the
worker stage, the rung's priced overhead for decode).  Real facade calls
on the ladder's device still execute every batch — results are
bit-identical to synchronous facade answers — but TIME is simulated, so a
run is a pure function of (spec, scenario, seed) and replays bit-exactly
(``serve.trace``).  The simulated clock, the arrival streams and the
tenant statistics are the JAX package's numpy code (``repro.serve.loop``)
copied verbatim, so a run here gives the same records to the last bit.

Pipeline timing model (per dispatched batch)::

    compute_start = max(now, worker pool free)
    compute_done  = compute_start + masked completion      (worker stage)
    decode_start  = max(compute_done, decoder free)
    decode_done   = decode_start + rung overhead           (decode stage)

With ``pipelined=True`` the loop resumes at ``compute_done`` — the next
batch's worker stage overlaps the decoder — and a request completes at
``decode_done``.  ``pipelined=False`` serialises the stages (the
synchronous baseline ``serve_bench`` compares against).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.chaos.serialize import report_to_dict
from repro_torch.control.driver import AdaptiveServer
from repro_torch.control.ladder import PlanLadder
from repro_torch.control.monitor import WorkerHealthMonitor
from repro_torch.core.simulator import TimeFeed
from repro_torch.serve.admission import AdmissionController, Request
from repro_torch.serve.batcher import Batch, ContinuousBatcher
from repro_torch.serve.tenants import RungFloorPolicy, SLOClass, TenantSpec

__all__ = ["StageTiming", "TwoStagePipeline", "RequestRecord",
           "BatchRecord", "ServeResult", "ServeTier"]


@dataclasses.dataclass(frozen=True)
class StageTiming:
    """Simulated timestamps of one batch's trip through the two stages."""

    compute_start_s: float
    compute_done_s: float
    decode_start_s: float
    decode_done_s: float


class TwoStagePipeline:
    """Simulated-clock bookkeeping for the worker/decoder stage pair.

    The worker pool and the decoder are the two exclusive resources; each
    batch occupies the workers for its masked completion, then the
    decoder for its rung overhead.  ``pipelined=False`` makes each batch
    hold BOTH resources to completion (back-to-back synchronous serving).
    """

    def __init__(self, pipelined: bool = True):
        self.pipelined = pipelined
        self.worker_free_s = 0.0
        self.decoder_free_s = 0.0

    def schedule(self, now_s: float, worker_s: float,
                 decode_s: float) -> StageTiming:
        """Book one batch through both stages starting no earlier than now."""
        start = max(now_s, self.worker_free_s)
        if not self.pipelined:
            start = max(start, self.decoder_free_s)
        compute_done = start + worker_s
        decode_start = max(compute_done, self.decoder_free_s)
        decode_done = decode_start + decode_s
        self.worker_free_s = compute_done
        self.decoder_free_s = decode_done
        return StageTiming(start, compute_done, decode_start, decode_done)

    @property
    def next_free_s(self) -> float:
        """When the loop may dispatch again (workers free; or fully drained
        when not pipelining)."""
        return self.worker_free_s if self.pipelined else self.decoder_free_s


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Everything that happened to one request (admitted OR shed)."""

    rid: int
    tenant: str
    slo_class: str
    arrival_s: float
    admitted: bool
    slo_s: float
    reject_reason: Optional[str] = None   # "rate_limited" | "queue_full"
    batch_index: Optional[int] = None
    rung: Optional[str] = None
    dispatch_s: Optional[float] = None    # worker stage start
    completion_s: Optional[float] = None  # decode done
    queue_delay_s: Optional[float] = None
    latency_s: Optional[float] = None     # end-to-end (queueing included)
    violated: Optional[bool] = None       # latency_s > slo_s
    span_id: Optional[str] = None         # span_id_for(seed, "request", rid)


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One dispatched batch: composition, stage timings, control report."""

    index: int
    slo_class: str
    rung: str
    size: int
    bucket: int                     # prewarmed bucket the batch padded to
    request_ids: Tuple[int, ...]
    dispatch_s: float
    worker_s: float                 # modelled worker-stage latency
    decode_s: float                 # rung's priced decode overhead
    compute_start_s: float
    compute_done_s: float
    decode_start_s: float
    decode_done_s: float
    report: dict                    # shared StepReport serialisation
    span_id: Optional[str] = None   # span_id_for(seed, "batch", index)


@dataclasses.dataclass
class ServeResult:
    """A finished tier run: per-request + per-batch records and summaries."""

    requests: Tuple[RequestRecord, ...]
    batches: Tuple[BatchRecord, ...]
    meta: dict
    #: rid -> decoded (r, t) product on the ladder's device, when the
    #: tier kept results.
    results: Optional[Dict[int, torch.Tensor]] = None

    @property
    def admitted(self) -> Tuple[RequestRecord, ...]:
        """Records of requests that made it past admission."""
        return tuple(r for r in self.requests if r.admitted)

    @property
    def shed(self) -> Tuple[RequestRecord, ...]:
        """Records of shed requests (each carries its rejection reason)."""
        return tuple(r for r in self.requests if not r.admitted)

    @property
    def completed(self) -> Tuple[RequestRecord, ...]:
        """Admitted records that finished decoding."""
        return tuple(r for r in self.requests
                     if r.admitted and r.completion_s is not None)

    def throughput_rps(self) -> float:
        """Sustained completions/s: completed over first-arrival->last-done."""
        done = self.completed
        if not done:
            return 0.0
        span = (max(r.completion_s for r in done)
                - min(r.arrival_s for r in self.requests))
        return len(done) / span if span > 0 else float("inf")

    def tenant_stats(self) -> Dict[str, dict]:
        """Per-tenant counts, latency quantiles, and SLO verdicts.

        ``p_slo_s`` is the realized latency at the tenant's OWN class
        quantile; ``slo_met`` judges it against the class bound.
        """
        quantiles: Dict[str, float] = self.meta.get("class_quantiles", {})
        out: Dict[str, dict] = {}
        for rec in self.requests:
            st = out.setdefault(rec.tenant, {
                "slo_class": rec.slo_class, "slo_s": rec.slo_s,
                "generated": 0, "admitted": 0, "completed": 0,
                "shed": 0, "shed_reasons": {}, "_lat": []})
            st["generated"] += 1
            if not rec.admitted:
                st["shed"] += 1
                st["shed_reasons"][rec.reject_reason] = (
                    st["shed_reasons"].get(rec.reject_reason, 0) + 1)
                continue
            st["admitted"] += 1
            if rec.completion_s is not None:
                st["completed"] += 1
                st["_lat"].append(rec.latency_s)
        for name, st in out.items():
            lat = np.asarray(st.pop("_lat"), dtype=np.float64)
            q = quantiles.get(st["slo_class"], 0.99)
            if lat.size:
                st["p50_s"] = float(np.percentile(lat, 50.0))
                st["p99_s"] = float(np.percentile(lat, 99.0))
                st["p_slo_s"] = float(np.percentile(lat, q * 100.0))
                st["max_s"] = float(lat.max())
                st["violations"] = int(np.sum(lat > st["slo_s"]))
                st["slo_met"] = bool(st["p_slo_s"] <= st["slo_s"])
            else:
                st.update(p50_s=None, p99_s=None, p_slo_s=None, max_s=None,
                          violations=0, slo_met=None)
        return out


class ServeTier:
    """Queue -> continuous batcher -> per-class servers -> staged pipeline.

    Args:
        ladder: prewarmed ``PlanLadder`` (with ``batch_sizes`` buckets for
            batching and ideally ``stages=True`` for recompile-free
            pipelining); shared by every SLO class.
        classes: the SLO classes to serve (each gets its own
            ``AdaptiveServer`` with its own quantile/floor/feedback).
        tenants: tenant specs; every tenant must reference a known class.
        feed: chaos ``TimeFeed`` over the ladder's K workers, consumed one
            step per DISPATCH across all classes (None = all workers take
            1.0s every step).
        overhead_s: deterministic per-rung decode costs used for policy
            pricing AND the simulated decode-stage latency (prewarm's
            measured overheads carry wall-clock noise, so reproducible
            runs pass constants).
        seed: workload seed (arrival streams key off it).
        score_threshold / sub_tasks / check_exact: forwarded to each
            class's ``AdaptiveServer``.
        pipelined: overlap decode of step t with the worker stage of step
            t+1 (False = synchronous back-to-back baseline).
        max_batch: batch-size ceiling; defaults to the largest prewarmed
            bucket (1 when none — pure per-request serving).
        split_stages: serve through the facade's split worker/decode
            entry points (defaults to True exactly when ``sub_tasks == 1``;
            partial decode has no split path and uses one-shot calls with
            identical timing accounting).
        keep_results: retain every decoded per-request product on the
            result, as a slice of its batch's product on the ladder's
            device (the bench's bit-identity check reads them; no host
            copy is made).

    Raises:
        ValueError: on unknown tenant classes, an empty class/tenant set,
            or ``split_stages=True`` with ``sub_tasks > 1``.
    """

    def __init__(self, ladder: PlanLadder, *,
                 classes: Sequence[SLOClass],
                 tenants: Sequence[TenantSpec],
                 feed: Optional[TimeFeed] = None,
                 overhead_s: Optional[dict] = None,
                 seed: int = 0,
                 score_threshold: float = 0.5,
                 sub_tasks: int = 1,
                 check_exact: bool = False,
                 pipelined: bool = True,
                 max_batch: Optional[int] = None,
                 split_stages: Optional[bool] = None,
                 keep_results: bool = False):
        if not classes:
            raise ValueError("need at least one SLO class")
        if not tenants:
            raise ValueError("need at least one tenant")
        self.ladder = ladder
        self.classes: Dict[str, SLOClass] = {c.name: c for c in classes}
        self.tenants: Dict[str, TenantSpec] = {t.name: t for t in tenants}
        for t in self.tenants.values():
            if t.slo_class not in self.classes:
                raise ValueError(
                    f"tenant {t.name!r} references unknown SLO class "
                    f"{t.slo_class!r}; have {sorted(self.classes)}")
        if split_stages is None:
            split_stages = sub_tasks == 1
        if split_stages and sub_tasks > 1:
            raise ValueError("split_stages requires sub_tasks == 1 (partial "
                             "decode panels are per chunk; no split path)")
        self.split_stages = split_stages
        self.pipelined = pipelined
        self.seed = int(seed)
        self.keep_results = keep_results
        self.overhead_s = overhead_s
        buckets = ladder.batch_buckets
        self.max_batch = int(max_batch if max_batch is not None
                             else (max(buckets) if buckets else 1))

        self._base_feed = feed or (
            lambda step, rng: np.full(ladder.K, 1.0, dtype=np.float64))
        self.dispatches = 0
        self.admission = AdmissionController(self.tenants)
        self.batcher = ContinuousBatcher(
            {name: t.slo_class for name, t in self.tenants.items()},
            self.max_batch)
        self.monitor = WorkerHealthMonitor(ladder.K)
        self.servers: Dict[str, AdaptiveServer] = {}
        for cls in classes:
            policy = RungFloorPolicy(
                ladder, q=cls.quantile, floor=cls.rung_floor,
                overhead_s=overhead_s, score_threshold=score_threshold,
                sub_tasks=sub_tasks)
            self.servers[cls.name] = AdaptiveServer(
                ladder, monitor=self.monitor, policy=policy,
                feed=self._shared_feed, score_threshold=score_threshold,
                seed=seed, check_exact=check_exact,
                slo_quantile=cls.quantile, slo_s=cls.slo_s,
                feedback=cls.feedback, sub_tasks=sub_tasks)
            # per-class obs scope: every class server shares the tier
            # seed, so step span IDs need the class name to stay unique.
            self.servers[cls.name].obs_scope = f"step.{cls.name}"

    # -- the shared scenario stream -----------------------------------------
    def _shared_feed(self, step: int, rng) -> np.ndarray:
        # per-class servers each count their OWN steps; the scenario
        # stream is indexed by the GLOBAL dispatch counter so the classes
        # interleave deterministically on one (seed, step)-keyed feed.
        t = np.asarray(self._base_feed(self.dispatches, rng),
                       dtype=np.float64)
        self.dispatches += 1
        return t

    # -- workload ------------------------------------------------------------
    def _arrivals(self, requests_per_tenant) -> List[Request]:
        """Seeded Poisson arrival streams, merged and id-stamped.

        Gaps are inverse-CDF exponentials over the uniform bitstream
        (the only sampling numpy keeps stable across versions), keyed
        ``(seed, tenant index)`` in sorted-tenant order.
        """
        if not isinstance(requests_per_tenant, dict):
            requests_per_tenant = {
                name: int(requests_per_tenant) for name in self.tenants}
        rows = []
        for idx, name in enumerate(sorted(self.tenants)):
            spec = self.tenants[name]
            cls = self.classes[spec.slo_class]
            rng = np.random.default_rng(
                np.random.SeedSequence((self.seed, idx)))
            t = 0.0
            for k in range(int(requests_per_tenant.get(name, 0))):
                t += float(-np.log1p(-rng.random()) / spec.arrival_rps)
                rows.append((t, idx, k, name, cls))
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        return [Request(rid=i, tenant=name, slo_class=cls.name,
                        arrival_s=float(t), deadline_s=float(t + cls.slo_s))
                for i, (t, idx, k, name, cls) in enumerate(rows)]

    # -- the event loop ------------------------------------------------------
    def run(self, make_A: Callable[[Request], object], B,
            requests_per_tenant) -> ServeResult:
        """Generate, admit, batch, and serve the whole workload to drain.

        Args:
            make_A: per-request left operand builder ``Request -> (v, r)``
                (an array or a tensor, moved to the ladder's device and
                dtype; deterministic builders give reproducible results).
            B: the shared (v, t) right operand (moved likewise).
            requests_per_tenant: int (same for every tenant) or
                ``{tenant: n}`` workload sizes.

        Returns:
            A :class:`ServeResult` with every request accounted for —
            completed, or shed with an explicit reason.

        Raises:
            RuntimeError: on a second call — monitor/feedback/queue state
                is consumed by a run; build a fresh tier to rerun.
        """
        if getattr(self, "_ran", False):
            raise RuntimeError("a ServeTier serves one workload; build a "
                               "fresh tier to run again")
        self._ran = True
        B = self._on_ladder(B)
        self._pipe = TwoStagePipeline(self.pipelined)
        arrivals = self._arrivals(requests_per_tenant)
        records: Dict[int, RequestRecord] = {}
        batches: List[BatchRecord] = []
        results: Dict[int, torch.Tensor] = {}
        # run the whole loop on a simulated-seconds obs clock: every span
        # recorded during the run (control decisions included) stamps the
        # loop's own deterministic `now`, so replays produce byte-identical
        # span streams.  No-op while obs is disabled.
        self._obs_clock = obs.SettableClock(0.0)
        obs.use_clock(self._obs_clock)
        i = 0
        now = 0.0
        while True:
            while i < len(arrivals) and arrivals[i].arrival_s <= now + 1e-9:
                req = arrivals[i]
                i += 1
                reason = self.admission.offer(req, req.arrival_s)
                if reason is None:
                    obs.count("serve.admit", tenant=req.tenant,
                              slo_class=req.slo_class)
                else:
                    obs.count("serve.shed", reason=reason,
                              tenant=req.tenant, slo_class=req.slo_class)
                records[req.rid] = RequestRecord(
                    rid=req.rid, tenant=req.tenant, slo_class=req.slo_class,
                    arrival_s=req.arrival_s, admitted=reason is None,
                    slo_s=self.classes[req.slo_class].slo_s,
                    reject_reason=reason,
                    span_id=obs.span_id_for(self.seed, "request", req.rid))
            batch = self.batcher.form(self.admission.queues)
            if batch is None:
                if i < len(arrivals):
                    now = max(now, arrivals[i].arrival_s)
                    continue
                break
            self._obs_clock.set(now)
            self._dispatch(batch, now, make_A, B, records, batches, results)
            now = max(now, self._pipe.next_free_s)
        meta = {
            "seed": self.seed, "pipelined": self.pipelined,
            "split_stages": self.split_stages, "max_batch": self.max_batch,
            "dispatches": self.dispatches,
            "class_quantiles": {c.name: c.quantile
                                for c in self.classes.values()},
        }
        ordered = tuple(records[rid] for rid in sorted(records))
        return ServeResult(requests=ordered, batches=tuple(batches),
                           meta=meta,
                           results=results if self.keep_results else None)

    def _on_ladder(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.ladder.dtype,
                               device=self.ladder.device)

    def _dispatch(self, batch: Batch, now: float, make_A, B,
                  records: Dict[int, RequestRecord],
                  batches: List[BatchRecord],
                  results: Dict[int, torch.Tensor]) -> None:
        """Serve one batch: control decision, staged execution, bookkeeping."""
        server = self.servers[batch.slo_class]
        A = torch.stack([self._on_ladder(make_A(r)) for r in batch.requests])
        decision = server.begin_step()
        t0 = time.perf_counter()
        if self.split_stages and decision.progress is None:
            Y, ctx = self.ladder.worker_stage(A, B)
            C = self.ladder.decode_stage(Y, ctx, mask=decision.mask)
        else:
            C = server.execute(decision, A, B)
        self.ladder.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        report = server.complete_step(decision, C, wall_ms, A, B)

        worker_s = float(report.sim_latency_s)
        decode_s = float(server.slo_policy.overhead_for(report.rung))
        timing = self._pipe.schedule(now, worker_s, decode_s)
        bucket = self.ladder.bucket_for(batch.size) or batch.size
        index = len(batches)
        span_id = obs.span_id_for(self.seed, "batch", index)
        # pre-timed simulated spans: one Perfetto track per SLO class,
        # with worker/decode lanes — overlapping slices on the two lanes
        # ARE the pipeline overlap (decode of batch t under workers of
        # batch t+1).
        obs.emit_span("serve.dispatch", now, timing.decode_done_s,
                      track=batch.slo_class, lane="dispatch",
                      batch=index, rung=report.rung, span_id=span_id)
        obs.emit_span("serve.worker_stage", timing.compute_start_s,
                      timing.compute_done_s, track=batch.slo_class,
                      lane="workers", batch=index, rung=report.rung,
                      span_id=span_id)
        obs.emit_span("serve.decode_stage", timing.decode_start_s,
                      timing.decode_done_s, track=batch.slo_class,
                      lane="decode", batch=index, rung=report.rung,
                      span_id=span_id)
        obs.observe("serve.stage.worker_s", worker_s, rung=report.rung)
        obs.observe("serve.stage.decode_s", decode_s, rung=report.rung)
        obs.count("serve.batch", slo_class=batch.slo_class)
        batches.append(BatchRecord(
            index=index, slo_class=batch.slo_class, rung=report.rung,
            size=batch.size, bucket=bucket,
            request_ids=tuple(r.rid for r in batch.requests),
            dispatch_s=now, worker_s=worker_s, decode_s=decode_s,
            compute_start_s=timing.compute_start_s,
            compute_done_s=timing.compute_done_s,
            decode_start_s=timing.decode_start_s,
            decode_done_s=timing.decode_done_s,
            report=report_to_dict(report),
            span_id=span_id))
        for j, req in enumerate(batch.requests):
            latency = timing.decode_done_s - req.arrival_s
            obs.observe("serve.latency_s", latency,
                        slo_class=batch.slo_class)
            obs.observe("serve.queue_delay_s",
                        timing.compute_start_s - req.arrival_s,
                        slo_class=batch.slo_class)
            records[req.rid] = dataclasses.replace(
                records[req.rid],
                batch_index=index, rung=report.rung,
                dispatch_s=timing.compute_start_s,
                completion_s=timing.decode_done_s,
                queue_delay_s=timing.compute_start_s - req.arrival_s,
                latency_s=latency,
                violated=latency > records[req.rid].slo_s)
            if self.keep_results:
                results[req.rid] = C[j]
