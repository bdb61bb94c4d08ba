"""Plan selection over the L <-> tau ladder: mean and tail-quantile policies.

The paper's Sec. IV tradeoff, run online: tighter entry bounds buy a lower
recovery threshold tau, and a lower tau buys a bigger erasure budget
``K - tau`` — more stragglers the next synchronous step can refuse to wait
for.  Both policies model the next step's completion under the monitor's
fitted per-worker ``LatencyModel``:

    step completion = max over kept workers of T_i,  T_i ~ base_i + Exp

where "kept" erases the monitor's flagged stragglers, worst first, up to
the rung's budget.  When a rung's budget covers every flagged straggler
and the budget is saturated this is exactly the tau-th order statistic of
the fitted finish times — the paper's latency model with the order
statistic now a *decision* (which mask to emit) instead of a passive
property of an async master.

``ExpectedLatencyPolicy`` ranks rungs by the MEAN of that distribution
plus the measured per-rung step cost; ``QuantileLatencyPolicy`` ranks by
its q-quantile (p99 by default) — straggler mitigation is a tail story,
and under heavy-tailed stragglers the two rankings genuinely disagree:
the mean hides the tail an SLO pays for.  Both implement the ``Policy``
protocol the ``AdaptiveServer`` drives.

Feasibility is gated by the entry bound: a rung whose digit stack
``(2L)^{p/p'}`` overflows the dtype mantissa (``core.bounds.is_safe``)
cannot decode exactly at this L and is never selected.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.simulator import (
    LatencyModel,
    WorkerTimes,
    completion_quantile,
    masked_completion_mean,
    masked_completion_quantile,
)
from repro_torch.control.ladder import PlanLadder
from repro_torch.control.partial import plan_partial_progress

__all__ = [
    "RungEstimate",
    "Policy",
    "ExpectedLatencyPolicy",
    "QuantileLatencyPolicy",
]


@dataclasses.dataclass(frozen=True)
class RungEstimate:
    """One rung's ranking entry."""

    rung: str
    tau: int
    budget: int                 # erasure budget K - tau
    feasible: bool              # digit stack fits the dtype mantissa at L
    expected_latency_s: float   # E[step completion] + per-rung overhead
    erased: Tuple[int, ...]     # stragglers the mask would erase on this rung
    unmasked_stragglers: int    # flagged stragglers the budget could NOT cover
    quantile: Optional[float] = None           # q of the tail estimate, if any
    quantile_latency_s: Optional[float] = None  # q-quantile completion + overhead
    progress: Optional[Tuple[float, ...]] = None  # partial plan (sub_tasks > 1)

    @property
    def metric_s(self) -> float:
        """The latency this estimate was ranked by (quantile if present)."""
        return (self.quantile_latency_s if self.quantile_latency_s is not None
                else self.expected_latency_s)


@runtime_checkable
class Policy(Protocol):
    """What the ``AdaptiveServer`` needs from a rung-selection policy.

    Any object with these four methods can drive the control loop; the
    two implementations here share ``_LatencyPolicyBase`` but a custom
    policy (e.g. round-robin, cost-aware) only has to satisfy this shape.
    """

    ladder: PlanLadder

    def feasible(self, rung: str) -> bool:
        """Exact decode possible for ``rung`` at the ladder's entry bound L."""
        ...  # pragma: no cover - protocol

    def estimate(self, rung: str, model: LatencyModel,
                 scores: Optional[np.ndarray] = None) -> "RungEstimate":
        """Latency estimate for serving the next step on ``rung``."""
        ...  # pragma: no cover - protocol

    def rank(self, model: LatencyModel,
             scores: Optional[np.ndarray] = None) -> Sequence["RungEstimate"]:
        """All rungs' estimates, best first."""
        ...  # pragma: no cover - protocol

    def select(self, model: LatencyModel,
               scores: Optional[np.ndarray] = None) -> "RungEstimate":
        """The best feasible rung; raises if the entry bound admits none."""
        ...  # pragma: no cover - protocol


class _LatencyPolicyBase:
    """Shared machinery: victims within budget, trial sampling, ranking.

    Subclasses implement ``_masked_estimate`` to turn the rung's survivor
    mask (under the fitted model) into a ``RungEstimate`` with the
    policy's ranking metric filled in.
    """

    def __init__(self, ladder: PlanLadder, *,
                 overhead_s: Optional[Mapping[str, float]] = None,
                 trials: int = 64, seed: int = 0,
                 score_threshold: float = 0.5, sub_tasks: int = 1):
        if sub_tasks < 1:
            raise ValueError(f"need sub_tasks >= 1, got {sub_tasks}")
        self.ladder = ladder
        self.overhead_s = dict(overhead_s) if overhead_s is not None else None
        self.trials = trials
        self.seed = seed
        self.score_threshold = score_threshold
        self.sub_tasks = int(sub_tasks)

    # -- feasibility (the L gate) -------------------------------------------
    def feasible(self, rung: str) -> bool:
        """Exact decode possible for ``rung`` at the ladder's entry bound L."""
        return self.ladder.feasible(rung)

    # -- shared completion model --------------------------------------------
    def _overhead(self, rung: str) -> float:
        src = (self.overhead_s if self.overhead_s is not None
               else self.ladder.step_overhead_s)
        return float(src.get(rung, 0.0))

    def overhead_for(self, rung: str) -> float:
        """The per-rung additive step cost this policy prices rungs with.

        Public so the server's observed-violation feedback can judge
        REALIZED step latencies (completion + overhead) against the same
        pricing the predictions use.
        """
        return self._overhead(rung)

    def _all_flagged(self, scores: Optional[np.ndarray]) -> np.ndarray:
        """Every worker scoring above threshold, worst first."""
        if scores is None:
            return np.empty(0, dtype=np.int64)
        scores = np.asarray(scores, dtype=np.float64)
        flagged = np.flatnonzero(scores > self.score_threshold)
        return flagged[np.argsort(-scores[flagged], kind="stable")]

    def _victims(self, rung: str, scores: Optional[np.ndarray]) -> Tuple[np.ndarray, int]:
        """(workers the rung's mask would erase, flagged-but-unmasked count)."""
        flagged = self._all_flagged(scores)
        budget = self.ladder.budget(rung)
        return flagged[:budget], max(0, flagged.size - budget)

    def _completions(self, weights: np.ndarray, model: LatencyModel) -> np.ndarray:
        """Per-trial step completions under ``weights`` sampled from ``model``.

        ``weights`` is the 0/1 survivor mask (binary policies) or the
        fractional progress plan (``sub_tasks > 1``).  A deterministic
        model (no jitter) needs a single sample; the rng is re-seeded per
        call so every rung (and every policy sharing a seed) sees the SAME
        sample paths — rankings then compare nested survivor sets on
        identical draws, never sampling noise.
        """
        rng = np.random.default_rng(self.seed)
        trials = self.trials if model.has_jitter else 1
        K = self.ladder.K
        lat = np.empty(trials)
        for t in range(trials):
            times = WorkerTimes(model.sample(K, (), rng))
            lat[t] = (times.completion_with_progress(weights)
                      if self.sub_tasks > 1
                      else times.completion_with_mask(weights))
        return lat

    def estimate(self, rung: str, model: LatencyModel,
                 scores: Optional[np.ndarray] = None) -> RungEstimate:
        """Latency estimate for serving the next step on ``rung``.

        With ``sub_tasks > 1`` the rung is priced under the REFINED law: the
        flagged stragglers' progress plan (``plan_partial_progress``) sets
        fractional waits, so a slow worker's expected contribution is no
        longer zero and the estimate carries the plan in ``progress``.
        """
        victims, unmasked = self._victims(rung, scores)
        if self.sub_tasks > 1:
            flagged = self._all_flagged(scores)
            K = self.ladder.K
            mean_s = np.maximum(
                model.base_vector(K) * (1.0 + model.jitter_vector(K)), 1e-12)
            progress = plan_partial_progress(
                mean_s, flagged, self.sub_tasks, self.ladder.tau(rung))
            victims = np.asarray([i for i in flagged if progress[i] == 0.0],
                                 dtype=np.int64)
            est = self._masked_estimate(rung, model, progress, victims,
                                        unmasked)
            return dataclasses.replace(
                est, progress=tuple(float(x) for x in progress))
        mask = np.ones(self.ladder.K, dtype=np.float64)
        mask[victims] = 0.0
        return self._masked_estimate(rung, model, mask, victims, unmasked)

    def _masked_estimate(self, rung, model, mask, victims,
                         unmasked) -> RungEstimate:
        raise NotImplementedError

    def _base_estimate(self, rung, expected_s, victims, unmasked,
                       **extra) -> RungEstimate:
        return RungEstimate(
            rung=rung,
            tau=self.ladder.tau(rung),
            budget=self.ladder.budget(rung),
            feasible=self.feasible(rung),
            expected_latency_s=float(expected_s) + self._overhead(rung),
            erased=tuple(int(w) for w in victims),
            unmasked_stragglers=unmasked,
            **extra,
        )

    # -- ranking --------------------------------------------------------------
    def rank(self, model: LatencyModel,
             scores: Optional[np.ndarray] = None) -> Sequence[RungEstimate]:
        """All rungs, best first: feasible before infeasible, then the
        policy's latency metric, then tau (prefer the lower threshold on a
        latency tie — it keeps the bigger erasure budget in reserve)."""
        ests = [self.estimate(r, model, scores) for r in self.ladder.rungs]
        return sorted(ests, key=lambda e: (not e.feasible,
                                           round(e.metric_s, 9),
                                           e.tau))

    def select(self, model: LatencyModel,
               scores: Optional[np.ndarray] = None) -> RungEstimate:
        """The best feasible rung; raises if the entry bound admits none."""
        best = self.rank(model, scores)[0]
        if not best.feasible:
            raise ValueError(
                f"no rung of ladder {self.ladder.rungs} decodes exactly at "
                f"L={self.ladder.L} in {self.ladder.dtype}")
        return best


class ExpectedLatencyPolicy(_LatencyPolicyBase):
    """Ranks a ``PlanLadder``'s rungs by EXPECTED next-step completion.

    Args:
        ladder: the plan family to rank.
        overhead_s: per-rung additive step cost (seconds) — typically the
            ladder's ``step_overhead_s`` measured at prewarm (decode
            dominates the spread between rungs).  Missing rungs cost 0.
        trials/seed: Monte-Carlo sampling of the fitted model.  With zero
            fitted jitter one sample is exact and the loop short-circuits.
        score_threshold: monitor score above which a worker counts as a
            straggler for masking purposes.
    """

    def _masked_estimate(self, rung, model, mask, victims,
                         unmasked) -> RungEstimate:
        lat = self._completions(mask, model)
        return self._base_estimate(rung, lat.mean(), victims, unmasked)


class QuantileLatencyPolicy(_LatencyPolicyBase):
    """Ranks rungs by the q-QUANTILE of next-step completion (tail SLO).

    The ranking metric is the q-quantile of the masked completion
    distribution plus the per-rung overhead.  By default the quantile is
    CLOSED-FORM: under the fitted shifted-exponential model the masked
    completion CDF is a product of per-worker factors and
    ``core.simulator.masked_completion_quantile`` inverts it exactly —
    no sampling noise in the tail, where Monte-Carlo is weakest, and no
    sampling at all (``expected_latency_s`` comes from the analytic mean
    too).  Pass ``analytic=False`` to rank by the empirical quantile of
    the same sampled trials the expected policy uses (useful for
    apples-to-apples comparisons and for feeds that are not
    shifted-exponential).

    Args:
        ladder: the plan family to rank.
        q: the SLO quantile in [0, 1] (0.99 = "p99 completion").
        analytic: closed-form CDF inversion (True) or empirical quantile
            of the sampled trials (False).
        overhead_s / trials / seed / score_threshold: as in
            ``ExpectedLatencyPolicy``.

    Raises:
        ValueError: if ``q`` is outside [0, 1].
    """

    def __init__(self, ladder: PlanLadder, *, q: float = 0.99,
                 analytic: bool = True,
                 overhead_s: Optional[Mapping[str, float]] = None,
                 trials: int = 64, seed: int = 0,
                 score_threshold: float = 0.5, sub_tasks: int = 1):
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q={q} outside [0, 1]")
        super().__init__(ladder, overhead_s=overhead_s, trials=trials,
                         seed=seed, score_threshold=score_threshold,
                         sub_tasks=sub_tasks)
        self.q = q
        self.analytic = analytic

    def _masked_estimate(self, rung, model, mask, victims,
                         unmasked) -> RungEstimate:
        if self.analytic:
            expected = masked_completion_mean(model, mask)
            tail = masked_completion_quantile(model, mask, self.q)
        else:
            lat = self._completions(mask, model)
            expected = lat.mean()
            tail = float(completion_quantile(lat, self.q))
        return self._base_estimate(
            rung, expected, victims, unmasked,
            quantile=self.q,
            quantile_latency_s=tail + self._overhead(rung))
