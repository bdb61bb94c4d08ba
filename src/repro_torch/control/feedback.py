"""Observed-violation feedback: close the SLO loop on what actually happened.

The SLO fallback (DESIGN Sec. 8.2) acts on PREDICTED quantiles of the
monitor's fitted shifted-exponential model.  When the fit is wrong — e.g.
Pareto-tailed stragglers, whose method-of-moments exponential fit
systematically underestimates the tail — predicted tails look safe while
realized violations pile up.  ``ViolationFeedback`` tracks REALIZED step
latencies against the SLO bound over a sliding window and adapts the
``QuantileLatencyPolicy``'s q:

    q_eff = clip(q_base + gain * (realized_rate - target_rate),
                 q_min, q_max)

with ``target_rate = 1 - q_base`` by default (a p99 SLO tolerates 1%
misses).  Excess realized violations TIGHTEN q (a higher quantile makes
every rung's predicted tail larger, so the predictive fallback fires
earlier and ranks more tail-protectively); a clean window LOOSENS q back
toward the base.  ``q_min`` defaults to ``q_base`` itself: with heavy
tails, "no recent misses" is weak evidence of safety — usually it means
the tightened q is WORKING — so loosening below the quantile the SLO was
stated at requires opting in with an explicit ``q_min``.  The law is
monotone non-decreasing in the realized violation rate, which is the
property tests pin down.

On top of the proportional law, ``force_after`` consecutive realized
violations assert ``force_tail_optimal``: the server then switches to the
quantile policy's pick outright, prediction be damned — the escape hatch
for a model so wrong that even the tightened-q prediction stays under the
bound.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

__all__ = ["FeedbackConfig", "ViolationFeedback"]


@dataclasses.dataclass(frozen=True)
class FeedbackConfig:
    """Knobs of the observed-violation control law.

    window:           sliding-window length (steps) the realized violation
                      rate is measured over.
    gain:             dq per unit of excess violation rate.
    q_min / q_max:    clip range of the effective quantile.  ``q_min=None``
                      (default) floors at ``q_base``: the law never
                      loosens below the quantile the SLO is stated at.
    min_observations: observations required before the law moves q off the
                      base (a near-empty window is all noise).
    force_after:      consecutive realized violations that assert
                      ``force_tail_optimal``.
    target_rate:      tolerated violation rate; None = ``1 - q_base``.
    threshold_gain:   d(threshold) per unit of excess violation rate for the
                      monitor's straggler-score threshold (see
                      :meth:`ViolationFeedback.effective_threshold`).
    threshold_min:    floor of the adaptive score threshold — the law never
                      tightens flagging below this (0 would flag everyone).
    """

    window: int = 16
    gain: float = 2.0
    q_min: Optional[float] = None
    q_max: float = 0.999
    min_observations: int = 4
    force_after: int = 3
    target_rate: Optional[float] = None
    threshold_gain: float = 1.0
    threshold_min: float = 0.1

    def __post_init__(self):
        """Validate the configuration ranges."""
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not 0.0 < self.q_max < 1.0:
            raise ValueError(f"q_max={self.q_max} outside (0, 1)")
        if self.q_min is not None and not 0.0 < self.q_min <= self.q_max:
            raise ValueError(
                f"need 0 < q_min <= q_max, got [{self.q_min}, {self.q_max}]")
        if self.gain < 0:
            raise ValueError(f"gain must be >= 0, got {self.gain}")
        if self.force_after < 1:
            raise ValueError(f"force_after must be >= 1, got {self.force_after}")
        if self.min_observations > self.window:
            # the window can never hold that many: the law would silently
            # stay at q_base forever
            raise ValueError(
                f"min_observations={self.min_observations} exceeds "
                f"window={self.window}; the feedback law could never engage")
        if self.target_rate is not None and not 0.0 <= self.target_rate <= 1.0:
            raise ValueError(f"target_rate={self.target_rate} outside [0, 1]")
        if self.threshold_gain < 0:
            raise ValueError(
                f"threshold_gain must be >= 0, got {self.threshold_gain}")
        if not 0.0 < self.threshold_min <= 1.0:
            raise ValueError(
                f"threshold_min={self.threshold_min} outside (0, 1]")


class ViolationFeedback:
    """Sliding-window realized-violation tracker + q control law.

    Args:
        q_base: the quantile the SLO is stated at (the fallback's anchor).
        slo_s: the SLO bound in seconds realized latencies are judged by.
        config: the control-law knobs (:class:`FeedbackConfig`).

    Raises:
        ValueError: for q_base outside (0, 1) or a non-positive SLO.
    """

    def __init__(self, q_base: float, slo_s: float,
                 config: FeedbackConfig = FeedbackConfig()):
        if not 0.0 < q_base < 1.0:
            raise ValueError(f"q_base={q_base} outside (0, 1)")
        if q_base >= config.q_max:
            # clip range collapses to a point: the proportional law could
            # never tighten (same can-never-engage class as
            # min_observations > window)
            raise ValueError(
                f"q_base={q_base} >= q_max={config.q_max}; raise q_max so "
                f"the feedback law has room to tighten")
        if slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {slo_s}")
        self.q_base = float(q_base)
        self.slo_s = float(slo_s)
        self.config = config
        self._window: collections.deque = collections.deque(
            maxlen=config.window)
        self._consecutive = 0
        self.violations = 0
        self.observations = 0

    def observe(self, realized_s: float) -> bool:
        """Fold one step's REALIZED latency in; True if it violated the SLO."""
        violated = bool(realized_s > self.slo_s)
        self._window.append(violated)
        self._consecutive = self._consecutive + 1 if violated else 0
        self.violations += violated
        self.observations += 1
        return violated

    @property
    def realized_rate(self) -> float:
        """Violation rate over the current window (0 while empty)."""
        if not self._window:
            return 0.0
        return sum(self._window) / len(self._window)

    @property
    def target_rate(self) -> float:
        """The tolerated violation rate the law regulates toward."""
        cfg = self.config.target_rate
        return (1.0 - self.q_base) if cfg is None else cfg

    @property
    def force_tail_optimal(self) -> bool:
        """True after ``force_after`` consecutive realized violations."""
        return self._consecutive >= self.config.force_after

    def effective_q(self) -> float:
        """The feedback-adjusted quantile for the NEXT step's predictions.

        Monotone non-decreasing in :attr:`realized_rate`; equals
        ``q_base`` until the window holds ``min_observations`` steps, and
        never drops below ``q_base`` unless ``q_min`` opts in.
        """
        if len(self._window) < self.config.min_observations:
            return self.q_base
        lo = self.q_base if self.config.q_min is None else self.config.q_min
        excess = self.realized_rate - self.target_rate
        return float(np.clip(self.q_base + self.config.gain * excess,
                             lo, self.config.q_max))

    def effective_threshold(self, base: float) -> float:
        """The feedback-adjusted straggler-score threshold for the monitor.

        The mirror image of :meth:`effective_q` for
        ``WorkerHealthMonitor``'s flagging threshold: excess realized
        violations LOWER the threshold (flag borderline-slow workers
        sooner, so the next mask/progress plan stops waiting on them); a
        clean window relaxes it back toward ``base``.  Monotone
        NON-INCREASING in :attr:`realized_rate`; equals ``base`` until the
        window holds ``min_observations`` steps, and never moves above
        ``base`` (relaxing beyond the configured threshold would erase
        nobody the operator asked to keep).

        Args:
            base: the configured threshold (``--monitor-threshold``).

        Returns:
            The clipped threshold in ``[min(threshold_min, base), base]``.
        """
        if len(self._window) < self.config.min_observations:
            return float(base)
        lo = min(self.config.threshold_min, float(base))
        excess = self.realized_rate - self.target_rate
        return float(np.clip(
            float(base) - self.config.threshold_gain * excess, lo, float(base)))
