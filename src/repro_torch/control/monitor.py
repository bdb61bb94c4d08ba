"""Live worker-health monitoring: EWMA latency tracking + straggler scoring.

``WorkerHealthMonitor`` turns per-step worker finish times into the two
artefacts the rest of the control plane consumes:

* an **erasure mask** for the next step — the highest-scoring stragglers,
  never more than the active code's erasure budget, so the synchronous
  synchronous step stops waiting for machines the monitor has seen lag; and
* a fitted ``LatencyModel`` — per-worker EWMA means plus a jitter estimate —
  that the expected-latency policy samples to rank ladder rungs.

Scoring is deliberately memoryful: a worker is flagged when its step time
exceeds ``straggler_factor`` x the step's fast-quartile time, and the flag feeds an
exponentially-decayed score, so one noisy step neither erases a healthy
worker nor instantly forgives a persistent straggler.
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.partial import plan_partial_progress
from repro_torch.core.simulator import LatencyModel

__all__ = ["WorkerHealthMonitor"]


class WorkerHealthMonitor:
    """Per-worker EWMA latency/variance + decayed straggler scores.

    alpha:            EWMA gain for the mean/variance estimates.
    score_decay:      per-step decay of the straggler score (score is a
                      convex blend: decay * old + (1 - decay) * flagged).
    straggler_factor: a worker is flagged when its step time exceeds this
                      multiple of the step's fast (25th-percentile) time.
    min_history:      steps to observe before the monitor will erase anyone
                      (a cold monitor emits the all-ones mask).
    """

    def __init__(self, K: int, *, alpha: float = 0.3, score_decay: float = 0.5,
                 straggler_factor: float = 1.5, min_history: int = 2):
        if K < 1:
            raise ValueError(f"need K >= 1 workers, got {K}")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha={alpha} outside (0, 1]")
        if not 0 <= score_decay < 1:
            raise ValueError(f"score_decay={score_decay} outside [0, 1)")
        if straggler_factor <= 1:
            raise ValueError(f"straggler_factor={straggler_factor} must be > 1")
        self.K = K
        self.alpha = alpha
        self.score_decay = score_decay
        self.straggler_factor = straggler_factor
        self.min_history = min_history
        self.steps = 0
        self._mean = np.zeros(K, dtype=np.float64)
        self._var = np.zeros(K, dtype=np.float64)
        self._score = np.zeros(K, dtype=np.float64)

    # -- ingest -------------------------------------------------------------
    def record_step(self, finish_times) -> None:
        """Fold one step's (K,) per-worker finish times into the estimates."""
        t = np.asarray(finish_times, dtype=np.float64)
        if t.shape != (self.K,):
            raise ValueError(f"finish times shape {t.shape} != ({self.K},)")
        if not np.all(np.isfinite(t)) or np.any(t < 0):
            raise ValueError("finish times must be finite and non-negative")
        if self.steps == 0:
            self._mean = t.copy()
        else:
            d = t - self._mean
            self._mean = self._mean + self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        # flag relative to the fast quartile, not the median: stays correct
        # while up to ~3/4 of the cluster straggles simultaneously
        flagged = t > self.straggler_factor * np.quantile(t, 0.25)
        self._score = (self.score_decay * self._score
                       + (1 - self.score_decay) * flagged)
        self.steps += 1

    def resize(self, keep=None, grow: int = 0) -> None:
        """Resize the tracked pool: keep survivors' state, cold-start joiners.

        ``keep`` lists the pool-local indices that survive (in their new
        order; default all), so an elastic shrink carries each survivor's
        EWMA mean/variance and straggler score to its compacted index
        instead of restarting the monitor.  ``grow`` appends that many new
        workers with zero straggler score and the survivor-average mean as
        their initial latency estimate (a joiner has no history; the pool
        average is the least-surprising prior and keeps ``fitted_model``
        well defined).  ``steps`` is NOT reset: the monitor stays past
        ``min_history`` across a handoff, so erasure masks keep flowing.

        Raises:
            ValueError: on duplicate/out-of-range ``keep`` indices,
                negative ``grow``, or an empty resulting pool.
        """
        idx = (np.arange(self.K, dtype=np.intp) if keep is None
               else np.asarray(keep, dtype=np.intp))
        if idx.ndim != 1 or len(set(idx.tolist())) != idx.size:
            raise ValueError(f"keep must be 1-D and duplicate-free: {keep!r}")
        if idx.size and (idx.min() < 0 or idx.max() >= self.K):
            raise ValueError(f"keep indexes outside the pool of {self.K}")
        if grow < 0:
            raise ValueError(f"grow must be >= 0, got {grow}")
        if idx.size + grow < 1:
            raise ValueError("resize would leave an empty pool")
        fill = (float(np.mean(self._mean[idx]))
                if self.steps and idx.size else 0.0)
        self._mean = np.concatenate(
            [self._mean[idx], np.full(grow, fill, dtype=np.float64)])
        self._var = np.concatenate(
            [self._var[idx], np.zeros(grow, dtype=np.float64)])
        self._score = np.concatenate(
            [self._score[idx], np.zeros(grow, dtype=np.float64)])
        self.K = int(idx.size + grow)

    # -- estimates ----------------------------------------------------------
    @property
    def mean(self) -> np.ndarray:
        """(K,) EWMA per-worker step latency."""
        return self._mean.copy()

    @property
    def std(self) -> np.ndarray:
        """(K,) EWMA per-worker latency standard deviation."""
        return np.sqrt(self._var)

    def straggler_scores(self) -> np.ndarray:
        """(K,) decayed scores in [0, 1]; ~1 = persistently slow."""
        return self._score.copy()

    def stragglers(self, threshold: float = 0.5) -> np.ndarray:
        """Worker ids scoring above ``threshold``, worst first."""
        ids = np.flatnonzero(self._score > threshold)
        return ids[np.argsort(-self._score[ids], kind="stable")]

    # -- control-plane outputs ----------------------------------------------
    def erasure_mask(self, budget: int, threshold: float = 0.5) -> np.ndarray:
        """0/1 mask for the NEXT step: erase up to ``budget`` stragglers.

        Only workers scoring above ``threshold`` are erased, worst first,
        and never more than ``budget`` (the active rung's K - tau), so the
        emitted mask always leaves a decodable survivor set.  A monitor
        with fewer than ``min_history`` steps emits the all-ones mask.
        """
        if budget < 0:
            raise ValueError(f"erasure budget must be >= 0, got {budget}")
        mask = np.ones(self.K, dtype=np.float64)
        if self.steps < self.min_history:
            return mask
        victims = self.stragglers(threshold)[:budget]
        mask[victims] = 0.0
        return mask

    def progress_plan(self, Q: int, tau: int,
                      threshold: float = 0.5) -> np.ndarray:
        """(K,) fractional progress for the NEXT step's partial decode.

        The fractional generalisation of :meth:`erasure_mask`: flagged
        workers start at zero chunks, and ``plan_partial_progress`` raises
        counts only where a chunk would be undercovered — so whenever the
        binary mask leaves a decodable survivor set the plan EQUALS that
        mask, and when flagging exceeds the erasure budget the cheapest
        slices of straggler work are consumed instead of waiting on full
        straggler steps.  A cold monitor emits all-ones (wait for all).
        """
        if self.steps < self.min_history:
            return np.ones(self.K, dtype=np.float64)
        return plan_partial_progress(np.maximum(self._mean, 1e-12),
                                     self.stragglers(threshold), Q, tau)

    def fitted_model(self, fallback_base: float = 1.0) -> LatencyModel:
        """Per-worker ``LatencyModel`` from the EWMA estimates.

        Method-of-moments fit of the shifted-exponential straggler model
        ``T_i = base_i + Exp(scale_i)`` (mean = base + scale, std = scale):
        per-worker ``base_i = mean_i - std_i`` and per-worker jitter
        ``scale_i / base_i``, so a heavy-tailed worker keeps its own tail
        instead of being averaged into a cluster-wide jitter.  A shifted
        exponential cannot have std > mean, so the scale is capped at the
        mean (a transient spike can push the EWMA std past the EWMA mean;
        the cap preserves the observed mean instead of collapsing the
        base to zero).  The fitted bases already carry each worker's
        observed slowness, so ``straggler_slowdown`` is 1 (callers sample
        with ``stragglers=()``).

        Args:
            fallback_base: homogeneous base used before any step was
                recorded (a cold monitor has no estimates).

        Returns:
            A ``LatencyModel`` whose quantiles/CDF the latency policies can
            evaluate in closed form (``core.simulator``).
        """
        if self.steps == 0:
            return LatencyModel(base=fallback_base, straggler_slowdown=1.0)
        mean = np.maximum(self._mean, 1e-12)
        scale = np.minimum(self.std, mean)
        base = np.maximum(mean - scale, 1e-12)
        return LatencyModel(base=base, straggler_slowdown=1.0,
                            jitter=scale / base)
