"""``AdaptiveServer``: the request loop that closes the control loop.

Each step: record per-worker finish times (real, or drawn from an injected
feed / ``LatencyModel`` for reproducible simulation) -> update the
``WorkerHealthMonitor`` -> let the policy re-rank the ``PlanLadder`` and
switch rungs -> emit the monitor's erasure mask (clamped to the active
rung's budget) -> serve the coded matmul through the active facade with the
mask as pure data.  ``CodedElasticPolicy`` consumes the same mask; when the
flagged-straggler count exhausts every rung's budget the server records a
respecialisation handoff (``plan_shrink`` target) instead of silently
waiting on known-slow machines forever.

SLO enforcement rides on top of whichever primary policy is installed:
with ``slo_quantile``/``slo_s`` set, every warm step also evaluates the
ACTIVE rung's modelled q-quantile completion, and a predicted violation
forces a switch to the tail-optimal rung immediately — off the re-rank
cadence, and even when the mean ranking disagrees.

``feedback=`` closes the loop on OBSERVED behaviour: a
``control.feedback.ViolationFeedback`` window judges each step's realized
latency (masked completion + the rung's priced overhead) against the SLO
bound and tightens/loosens the quantile the predictions are stated at —
so a fitted model that underestimates the true tail (e.g. Pareto
stragglers) gets corrected by the misses it causes, and a run of
consecutive realized violations forces the tail-optimal rung outright.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.api import uncoded_matmul
from repro_torch.core.points import extend_points
from repro_torch.core.simulator import LatencyModel, TimeFeed, WorkerTimes
from repro_torch.distributed.elastic import CodedElasticPolicy, plan_shrink
from repro_torch.control.feedback import FeedbackConfig, ViolationFeedback
from repro_torch.control.ladder import PlanLadder
from repro_torch.control.monitor import WorkerHealthMonitor
from repro_torch.control.policy import (
    ExpectedLatencyPolicy,
    Policy,
    QuantileLatencyPolicy,
)

__all__ = ["StepReport", "StepDecision", "AdaptiveServer"]


def _exact(C: torch.Tensor, A, B) -> bool:
    """C equals the uncoded oracle ``A^T B``, compared on C's device.

    The oracle runs on the device (a host copy of an 8000^2 product would
    cost about 1 GB of transfers per step); C is widened to the oracle's
    float64 exactly, as a numpy comparison would promote it.
    """
    ref = uncoded_matmul(torch.as_tensor(A, device=C.device),
                         torch.as_tensor(B, device=C.device))
    return C.shape == ref.shape and torch.equal(C.to(ref.dtype), ref)


@dataclasses.dataclass(frozen=True)
class StepReport:
    """What one adaptive serving step did and cost."""

    step: int
    rung: str
    switched: bool
    erased: Tuple[int, ...]        # workers the mask dropped this step
    sim_latency_s: float           # modelled step completion (mask-aware)
    wall_ms: float                 # measured facade-call wall time
    slack: int                     # elastic slack AFTER applying the mask
    respecialize: bool             # erasure budget exhausted ladder-wide
    shrink_target: Optional[Tuple[int, int]]  # plan_shrink mesh on handoff
    exact: Optional[bool]          # vs uncoded oracle (None = not checked)
    slo_violation: bool = False    # predicted q-quantile exceeded the SLO
    predicted_tail_s: Optional[float] = None  # SERVED rung's modelled q-quantile
    realized_s: Optional[float] = None        # realized latency the feedback judged
    realized_violation: bool = False          # realized latency exceeded the SLO
    q_effective: Optional[float] = None       # feedback-adjusted quantile this step
    progress: Optional[Tuple[float, ...]] = None  # partial plan (sub_tasks > 1)
    threshold_effective: Optional[float] = None   # adaptive monitor threshold
    span_id: Optional[str] = None  # seed-derived obs correlation ID
    pool: Optional[Tuple[int, ...]] = None  # universe ids serving (elastic)


@dataclasses.dataclass(frozen=True)
class StepDecision:
    """The CONTROL half of one serving step, before any facade call.

    ``begin_step`` runs the whole decision sequence — feed ingestion,
    monitor update, feedback restatement, policy (re)ranking, SLO
    fallback, mask/progress planning, elastic bookkeeping — and freezes
    the result here; ``complete_step`` turns it into a ``StepReport``
    once the decoded product is in hand.  The split exists so a serving
    loop can interleave the EXECUTION of one step (worker stage, decode
    stage) with other work — e.g. pipelining decode of step *t* against
    the worker stage of step *t+1* — without re-entering the control
    logic.  ``step()`` composes begin/execute/complete back-to-back and
    is bit-identical to the pre-split loop.
    """

    step: int                      # the server step this decision is for
    times: np.ndarray              # the (K,) per-worker finish times ingested
    rung: str                      # rung that will serve (already switched to)
    switched: bool                 # did the decision change the active rung
    mask: np.ndarray               # (K,) 0/1 erasure mask (derived when partial)
    progress: Optional[np.ndarray]  # (K,) fractional plan (sub_tasks > 1)
    slo_violation: bool            # predicted q-quantile exceeded the SLO
    predicted_tail_s: Optional[float]  # served rung's modelled q-quantile
    q_effective: Optional[float]   # feedback-adjusted quantile this step
    threshold_effective: Optional[float]  # feedback-adjusted flag threshold
    respecialize: bool             # erasure budget exhausted ladder-wide
    shrink_target: Optional[Tuple[int, int]]  # plan_shrink mesh on handoff
    pool: Optional[Tuple[int, ...]] = None  # universe ids serving (elastic)


class AdaptiveServer:
    """Monitor -> policy -> ladder, per request.

    Args:
        ladder: the prewarmed ``PlanLadder`` to serve through.
        monitor: worker-health state; a fresh ``WorkerHealthMonitor`` of the
            ladder's K by default.
        policy: primary rung-selection ``Policy``.  Defaults to
            ``ExpectedLatencyPolicy``, or ``QuantileLatencyPolicy`` when
            ``slo_quantile`` is given and no policy is passed explicitly.
        feed: injectable per-worker finish-time source; defaults to sampling
            ``fallback_model`` with no stragglers (a healthy cluster).  Real
            deployments pass measured per-worker step times instead.
        fallback_model: the healthy-cluster model backing the default feed.
        reevaluate_every: policy cadence in steps (1 = every step).
        score_threshold: monitor score above which a worker counts as a
            straggler.
        seed: rng seed for the default feed.
        check_exact: compare every decoded C against the uncoded oracle.
        slo_quantile: tail quantile the SLO is stated at (e.g. 0.99); turns
            on per-step tail prediction.
        slo_s: the SLO bound in seconds.  When the active rung's predicted
            ``slo_quantile``-completion exceeds it, the server immediately
            switches to the tail-optimal feasible rung (bypassing the
            cadence and the primary ranking).
        feedback: observed-violation feedback over the SLO.  ``True``
            enables it with the default ``FeedbackConfig``; a
            ``FeedbackConfig`` customises the control law.  Each step's
            REALIZED latency (masked completion + the rung's priced
            overhead) is judged against ``slo_s``; the realized violation
            rate tightens/loosens the quantile all predictions are stated
            at, and ``force_after`` consecutive misses force the
            tail-optimal rung regardless of prediction.  The same window
            also adapts the monitor's flagging threshold
            (``effective_threshold``): realized misses tighten flagging,
            calm windows relax it back to ``score_threshold``.
        sub_tasks: sub-task count Q per worker.  With ``Q > 1`` each step
            serves through the partial-straggler decode: the monitor's
            ``progress_plan`` consumes completed chunk prefixes from
            flagged stragglers instead of erasing them outright, and both
            policies rank rungs under the refined fractional law.  ``Q=1``
            is the legacy binary loop, bit for bit.
        universe: total worker-fleet size for ELASTIC pool execution.
            When set, the feed emits ``(universe,)`` per-worker times and
            the server serves on a subset of that fleet (``pool``); a
            ``must_respecialize`` step then EXECUTES the handoff — the
            ladder re-lowers onto the survivor pool's evaluation points —
            and :meth:`grow` admits joiners on Leja-extended points.
            ``None`` (default) is the fixed-pool loop, bit for bit.
        pool: initial universe member ids serving (elastic mode only);
            must have exactly ``ladder.K`` entries.  Defaults to the
            first ``ladder.K`` universe members.

    Raises:
        ValueError: if ``slo_s`` is given without ``slo_quantile``,
            ``feedback`` without both, ``sub_tasks < 1``, or an invalid
            ``universe``/``pool`` combination.
    """

    def __init__(self, ladder: PlanLadder, *,
                 monitor: Optional[WorkerHealthMonitor] = None,
                 policy: Optional[Policy] = None,
                 feed: Optional[TimeFeed] = None,
                 fallback_model: Optional[LatencyModel] = None,
                 reevaluate_every: int = 1,
                 score_threshold: float = 0.5,
                 seed: int = 0,
                 check_exact: bool = False,
                 slo_quantile: Optional[float] = None,
                 slo_s: Optional[float] = None,
                 feedback: Union[bool, FeedbackConfig, None] = None,
                 sub_tasks: int = 1,
                 universe: Optional[int] = None,
                 pool: Optional[Sequence[int]] = None):
        if slo_s is not None and slo_quantile is None:
            raise ValueError("slo_s needs slo_quantile (the quantile the "
                             "SLO is stated at)")
        if feedback and (slo_quantile is None or slo_s is None):
            raise ValueError("feedback needs slo_quantile AND slo_s (it "
                             "judges realized latencies against the bound)")
        if sub_tasks < 1:
            raise ValueError(f"need sub_tasks >= 1, got {sub_tasks}")
        self.sub_tasks = int(sub_tasks)
        self.ladder = ladder
        self.monitor = monitor or WorkerHealthMonitor(ladder.K)
        self.slo_policy: Optional[QuantileLatencyPolicy] = None
        if slo_quantile is not None:
            # inherit the primary policy's overhead override (if any) so the
            # SLO fallback and the primary ranking price rungs identically.
            self.slo_policy = QuantileLatencyPolicy(
                ladder, q=slo_quantile, score_threshold=score_threshold,
                overhead_s=getattr(policy, "overhead_s", None),
                sub_tasks=sub_tasks)
        if policy is None:
            policy = self.slo_policy or ExpectedLatencyPolicy(
                ladder, score_threshold=score_threshold, sub_tasks=sub_tasks)
        self.policy = policy
        self.slo_s = slo_s
        self.feedback: Optional[ViolationFeedback] = None
        if feedback:
            config = (feedback if isinstance(feedback, FeedbackConfig)
                      else FeedbackConfig())
            self.feedback = ViolationFeedback(slo_quantile, slo_s, config)
        self.elastic = CodedElasticPolicy(
            K=ladder.K, tau=ladder.tau(ladder.active))
        self.universe: Optional[int] = None
        self.pool: Optional[np.ndarray] = None
        if universe is not None:
            if universe < ladder.K:
                raise ValueError(
                    f"universe={universe} smaller than the pool K={ladder.K}")
            self.universe = int(universe)
            members = (np.arange(ladder.K, dtype=np.intp) if pool is None
                       else np.asarray(pool, dtype=np.intp))
            if (members.ndim != 1 or members.size != ladder.K
                    or len(set(members.tolist())) != members.size):
                raise ValueError(
                    f"pool must list {ladder.K} distinct universe members, "
                    f"got {pool!r}")
            if members.min() < 0 or members.max() >= self.universe:
                raise ValueError(
                    f"pool members outside the universe of {self.universe}")
            self.pool = members.copy()
        elif pool is not None:
            raise ValueError("pool= requires universe= (elastic mode)")
        self._feed = feed
        self._fallback = fallback_model or LatencyModel(base=1.0, jitter=0.0)
        self.reevaluate_every = max(1, reevaluate_every)
        self.score_threshold = score_threshold
        self.check_exact = check_exact
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.steps = 0
        self.reports: List[StepReport] = []
        # obs correlation scope: span IDs are span_id_for(seed, scope, step).
        # Loops running SEVERAL servers off one seed (the serve tier's
        # per-SLO-class servers) set a distinct scope per server so their
        # step IDs never collide.
        self.obs_scope = "step"

    # -- worker-time ingestion ----------------------------------------------
    def _worker_times(self) -> np.ndarray:
        """One step of per-worker finish times: (universe,) when elastic
        (the fleet keeps emitting for non-members), else (K,)."""
        width = self.universe if self.universe is not None else self.ladder.K
        if self._feed is not None:
            t = np.asarray(self._feed(self.steps, self.rng), dtype=np.float64)
            if t.shape != (width,):
                raise ValueError(
                    f"feed returned shape {t.shape}, need ({width},)")
            return t
        return self._fallback.sample(width, (), self.rng)

    def _switch_to(self, rung: str) -> bool:
        """Activate ``rung`` (carrying elastic state); True if it changed."""
        if rung == self.ladder.active:
            return False
        self.ladder.switch(rung)
        self.elastic = CodedElasticPolicy(
            K=self.ladder.K, tau=self.ladder.tau(rung),
            healthy=self.elastic.healthy.copy())
        return True

    # -- elastic pool execution ----------------------------------------------
    def _execute_shrink(self, threshold: float) -> bool:
        """Drop the flagged stragglers and re-lower onto the survivors.

        The executed half of the respecialisation handoff: survivors keep
        their evaluation points (a subset of the ladder's), the ladder
        re-lowers its rung family onto them reusing the shared cache
        group, and monitor/elastic state compacts to the survivor
        indices.  Returns False — leaving the step a flag-only handoff,
        exactly the fixed-pool behaviour — when no rung fits the survivor
        pool or nobody survives.
        """
        victims = self.monitor.stragglers(threshold)
        keep = np.setdiff1d(np.arange(self.ladder.K, dtype=np.intp), victims)
        if keep.size == 0:
            return False
        try:
            self.ladder.respecialize(self.ladder.z_points[keep])
        except ValueError:
            return False  # survivor pool below every rung's tau
        self.monitor.resize(keep=keep)
        self.elastic.shrink(keep)
        self.elastic.tau = self.ladder.tau(self.ladder.active)
        self.pool = self.pool[keep]
        obs.count("control.pool.shrink", dropped=int(victims.size))
        return True

    def grow(self, joiners: Sequence[int]) -> None:
        """Admit ``joiners`` (universe ids) onto Leja-extended points.

        The symmetric elastic path: the ladder's evaluation points extend
        by ``len(joiners)`` fresh Leja points (``core.points
        .extend_points``) and every rung re-lowers incrementally —
        surviving workers' encoded-task coefficients, cached decode
        panels, and built pipelines for the old pool are untouched,
        so only the grown pool's pipelines build.  Joiners append at
        the END of the pool (they own the new points) and start cold in
        the monitor.

        Raises:
            ValueError: on a fixed-pool server, an empty/duplicate joiner
                list, ids outside the universe, or ids already serving.
        """
        if self.pool is None:
            raise ValueError("grow() needs an elastic server (universe=)")
        ids = np.asarray(joiners, dtype=np.intp)
        if ids.ndim != 1 or ids.size < 1:
            raise ValueError(f"joiners must be 1-D non-empty, got {joiners!r}")
        if len(set(ids.tolist())) != ids.size:
            raise ValueError(f"duplicate joiner ids: {joiners!r}")
        if ids.min() < 0 or ids.max() >= self.universe:
            raise ValueError(
                f"joiners outside the universe of {self.universe}")
        if np.intersect1d(ids, self.pool).size:
            raise ValueError(f"joiners already in the pool: {joiners!r}")
        g = int(ids.size)
        self.ladder.respecialize(extend_points(self.ladder.z_points, g))
        self.monitor.resize(grow=g)
        self.elastic.grow(g)
        self.elastic.tau = self.ladder.tau(self.ladder.active)
        self.pool = np.concatenate([self.pool, ids])
        obs.count("control.pool.grow", joined=g)

    # -- one serving step ----------------------------------------------------
    def begin_step(self) -> StepDecision:
        """Run the control half of one step: ingest times, decide, plan.

        Consumes exactly one feed step and mutates every piece of control
        state (monitor, feedback, ladder rung, elastic policy) exactly as
        the head of the legacy ``step()`` did.  Pair each call with exactly
        one ``complete_step`` — the step counter only advances there.
        """
        with obs.span("control.begin_step", step=self.steps,
                      scope=self.obs_scope):
            decision = self._decide()
        if decision.switched:
            obs.count("control.switch", rung=decision.rung)
        if decision.slo_violation:
            obs.count("control.slo_fallback", rung=decision.rung)
        if decision.respecialize:
            obs.count("control.respecialize")
        return decision

    def _decide(self) -> StepDecision:
        times_all = self._worker_times()
        times = times_all if self.pool is None else times_all[self.pool]
        self.monitor.record_step(times)
        scores = self.monitor.straggler_scores()

        switched = False
        slo_violation = False
        predicted_tail = None
        q_eff = None
        thr = self.score_threshold
        thr_eff = None
        if self.feedback is not None:
            # realized violations re-state the quantile every prediction
            # this step is made at (selection, tail estimate, fallback) —
            # including a user-supplied quantile PRIMARY, which would
            # otherwise keep ranking at the stale base q.
            q_eff = self.feedback.effective_q()
            self.slo_policy.q = q_eff
            if (self.policy is not self.slo_policy
                    and isinstance(self.policy, QuantileLatencyPolicy)):
                self.policy.q = q_eff
            # ...and re-state the flagging threshold the masks/plans and
            # both policies' victim sets are computed at: misses tighten
            # flagging, calm windows relax it back to the configured base.
            thr = thr_eff = self.feedback.effective_threshold(
                self.score_threshold)
            for p in (self.policy, self.slo_policy):
                if p is not None and hasattr(p, "score_threshold"):
                    p.score_threshold = thr
        # a cold monitor ranks on noise: hold the initial rung until the
        # EWMA estimates have min_history steps behind them (same gating
        # the monitor applies to its erasure mask).
        if self.monitor.steps >= self.monitor.min_history:
            model = self.monitor.fitted_model()
            best = None
            if self.steps % self.reevaluate_every == 0:
                best = self.policy.select(model, scores)
                switched = self._switch_to(best.rung)
            if self.slo_policy is not None:
                # when the quantile policy IS the primary and just ranked,
                # its winning estimate already describes the active rung —
                # reuse it instead of re-running the closed-form estimate.
                primary_is_slo = (self.policy is self.slo_policy
                                  and best is not None
                                  and best.rung == self.ladder.active)
                if primary_is_slo:
                    predicted_tail = best.quantile_latency_s
                else:
                    predicted_tail = self.slo_policy.estimate(
                        self.ladder.active, model, scores).quantile_latency_s
                if self.slo_s is not None and predicted_tail > self.slo_s:
                    # SLO fallback: the ACTIVE rung is predicted to blow the
                    # tail budget — switch to the tail-optimal rung NOW,
                    # regardless of cadence or the primary (mean) ranking.
                    slo_violation = True
                    fallback = (best if primary_is_slo
                                else self.slo_policy.select(model, scores))
                    if self._switch_to(fallback.rung):
                        switched = True
                        # report the tail of the rung that will SERVE
                        predicted_tail = fallback.quantile_latency_s
            if (self.feedback is not None and not slo_violation
                    and self.feedback.force_tail_optimal):
                # the model keeps predicting "fine" while reality keeps
                # violating: stop trusting it and take the tail-optimal
                # rung outright.
                forced = self.slo_policy.select(model, scores)
                if self._switch_to(forced.rung):
                    switched = True
                    predicted_tail = forced.quantile_latency_s

        progress = None
        if self.sub_tasks > 1:
            # fractional generalisation of the erasure mask: flagged
            # workers contribute completed chunk prefixes instead of being
            # erased outright (or waited on in full past the budget).
            progress = self.monitor.progress_plan(
                self.sub_tasks, self.ladder.tau(self.ladder.active), thr)
            mask = (progress > 0).astype(np.float64)
        else:
            budget = self.ladder.budget(self.ladder.active)
            mask = self.monitor.erasure_mask(budget, thr)
        self.elastic.observe_mask(mask)

        # ladder-wide exhaustion: more persistent stragglers than even the
        # widest-budget FEASIBLE rung can erase -> respecialisation handoff.
        flagged = self.monitor.stragglers(thr).size
        max_budget = max((self.ladder.budget(r) for r in self.ladder.rungs
                          if self.policy.feasible(r)), default=0)
        respecialize = flagged > max_budget and self.elastic.must_respecialize
        shrink_target = None
        if respecialize:
            healthy = self.ladder.K - flagged
            try:
                shrink_target = plan_shrink(healthy)
            except ValueError:
                shrink_target = None  # not even a 1x1 mesh left
            if self.pool is not None:
                # ELASTIC: execute the handoff now — this very step serves
                # on the survivor pool's re-lowered ladder.
                rung_before = self.ladder.active
                if self._execute_shrink(thr):
                    switched = switched or self.ladder.active != rung_before
                    times = times_all[self.pool]
                    if self.sub_tasks > 1:
                        progress = self.monitor.progress_plan(
                            self.sub_tasks,
                            self.ladder.tau(self.ladder.active), thr)
                        mask = (progress > 0).astype(np.float64)
                    else:
                        mask = self.monitor.erasure_mask(
                            self.ladder.budget(self.ladder.active), thr)
                    self.elastic.observe_mask(mask)

        return StepDecision(
            step=self.steps,
            times=times,
            rung=self.ladder.active,
            switched=switched,
            mask=mask,
            progress=progress,
            slo_violation=slo_violation,
            predicted_tail_s=predicted_tail,
            q_effective=q_eff,
            threshold_effective=thr_eff,
            respecialize=respecialize,
            shrink_target=shrink_target,
            pool=(None if self.pool is None
                  else tuple(int(x) for x in self.pool)),
        )

    def execute(self, decision: StepDecision, A, B) -> torch.Tensor:
        """The one-shot facade call ``decision`` prescribes (no pipelining).

        A serving loop wanting the two-stage overlap calls the ladder's
        ``worker_stage``/``decode_stage`` with ``decision.mask`` instead;
        either route is bit-identical.
        """
        with obs.span("control.execute", rung=decision.rung,
                      step=decision.step):
            if decision.progress is not None:
                return self.ladder(A, B, progress=decision.progress,
                                   sub_tasks=self.sub_tasks)
            return self.ladder(A, B, mask=decision.mask)

    def complete_step(self, decision: StepDecision, C, wall_ms: float,
                      A=None, B=None) -> StepReport:
        """Close out a ``begin_step`` decision once its product is decoded.

        Prices the step (masked/fractional completion of the ingested
        times), feeds the realized latency to the violation feedback, runs
        the optional exactness check (needs ``A``/``B``), and appends +
        returns the ``StepReport``.  Advances the step counter.
        """
        times, mask, progress = decision.times, decision.mask, decision.progress
        exact = None
        if self.check_exact and A is not None:
            exact = _exact(C, A, B)

        with obs.span("control.complete_step", step=decision.step,
                      scope=self.obs_scope):
            sim_latency = (
                WorkerTimes(times).completion_with_progress(progress)
                if progress is not None
                else WorkerTimes(times).completion_with_mask(mask))
            realized = None
            realized_violation = False
            if self.feedback is not None:
                # realized = what this step actually cost under the model's
                # own pricing: masked completion + the served rung's
                # overhead (the same additive cost every prediction carries).
                realized = sim_latency + self.slo_policy.overhead_for(
                    decision.rung)
                realized_violation = self.feedback.observe(realized)

        report = StepReport(
            step=decision.step,
            rung=decision.rung,
            switched=decision.switched,
            erased=tuple(int(i) for i in np.flatnonzero(mask == 0)),
            sim_latency_s=sim_latency,
            wall_ms=wall_ms,
            slack=self.elastic.slack,
            respecialize=decision.respecialize,
            shrink_target=decision.shrink_target,
            exact=exact,
            slo_violation=decision.slo_violation,
            predicted_tail_s=decision.predicted_tail_s,
            realized_s=realized,
            realized_violation=realized_violation,
            q_effective=decision.q_effective,
            progress=(None if progress is None
                      else tuple(float(x) for x in progress)),
            threshold_effective=decision.threshold_effective,
            span_id=obs.span_id_for(self.seed, self.obs_scope,
                                    decision.step),
            pool=decision.pool,
        )
        obs.observe("control.sim_latency_s", sim_latency, rung=decision.rung)
        if realized_violation:
            obs.count("control.realized_violation", rung=decision.rung)
        self.reports.append(report)
        self.steps += 1
        return report

    def step(self, A, B) -> Tuple[torch.Tensor, StepReport]:
        """Serve one coded matmul request through the control loop.

        ``begin_step`` (decide) -> ``execute`` (one-shot facade call) ->
        ``complete_step`` (price, feed back, report), composed
        back-to-back; bit-identical to the pre-split synchronous loop.

        Args:
            A: (v, r) or batch-leading (b, v, r) left operand.
            B: (v, t) right operand (shared across a batch).

        Returns:
            ``(C, StepReport)`` — the decoded product and what the loop did.
        """
        decision = self.begin_step()
        t0 = time.perf_counter()
        C = self.execute(decision, A, B)
        self.ladder.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        return C, self.complete_step(decision, C, wall_ms, A, B)

    def run(self, requests, make_request: Callable[[int], Tuple]) -> List[StepReport]:
        """Serve ``requests`` steps of ``make_request(step) -> (A, B)``."""
        start = len(self.reports)
        for i in range(requests):
            self.step(*make_request(i))
        return self.reports[start:]
