"""Async-cluster straggler simulator (reproduces the paper's Fig. 1 setup).

The paper runs 10 AWS workers; stragglers are simulated by making S randomly
chosen machines perform their local computation twice.  Completion latency of
a scheme with threshold tau is the tau-th smallest worker finish time plus
the decode time.  We reproduce this as a discrete-event model fed with real
measured per-worker compute times (the worker matmul run on this host) so the
comparison between schemes is apples-to-apples.

Two completion conventions coexist:

* **async master** (the paper's Fig. 1): the master decodes as soon as ANY
  tau workers finish — ``WorkerTimes.completion_for_threshold``.
* **synchronous step** (the mesh runtime, DESIGN Sec. 3): a
  mesh step waits for EVERY worker that is not declared erased; the
  0/1 mask is the only way to not wait for a straggler —
  ``WorkerTimes.completion_with_mask``.  The control plane
  (the control plane) exists to close that gap: an accurate mask makes the
  synchronous step complete at the tau-th order statistic.

``simulate_completion`` accepts an injectable per-worker time ``feed`` so
recorded traces (or a health monitor's fitted model) can replace the
parametric ``LatencyModel``; ``completion_cdf``/``completion_quantile``
summarise trial latencies, and ``masked_completion_quantile``/
``masked_completion_cdf`` give the per-rung step-completion distribution
under a fitted model in closed form — the tail statistics the control
plane's SLO-aware ``QuantileLatencyPolicy`` ranks rungs by.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

__all__ = [
    "WorkerTimes",
    "simulate_completion",
    "measure_worker_time",
    "LatencyModel",
    "TimeFeed",
    "completion_cdf",
    "completion_quantile",
    "masked_completion_cdf",
    "masked_completion_mean",
    "masked_completion_quantile",
]

#: Injectable per-worker finish-time source: (trial_index, rng) -> (K,) seconds.
TimeFeed = Callable[[int, np.random.Generator], np.ndarray]


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Per-worker finish-time model.

    Each worker's finish time is a shifted exponential

        T_i = base_i * slowdown_i + Exp(jitter_i * base_i * slowdown_i)

    (slowdown applies only to the trial's straggler set), the standard
    cloud straggler model the related polynomial-code analyses use.

    base: seconds of useful compute — a scalar (homogeneous cluster) or a
    (K,)-vector of per-worker means (e.g. fitted by
    ``control.WorkerHealthMonitor`` from live EWMA latencies).
    straggler_slowdown: multiplicative factor for stragglers (paper: 2.0 -
    the straggler computes twice).
    jitter: optional exponential jitter scale (fraction of base) applied to
    every worker - models cloud variance; 0 reproduces the paper's
    deterministic duplication model.  A (K,)-vector gives per-worker
    scales (heavy-tailed straggler mixes; the monitor's moment fit).
    """

    base: Union[float, np.ndarray]
    straggler_slowdown: float = 2.0
    jitter: Union[float, np.ndarray] = 0.0

    def base_vector(self, K: int) -> np.ndarray:
        """The (K,) per-worker mean compute times."""
        return self._vector(self.base, K, "base")

    def jitter_vector(self, K: int) -> np.ndarray:
        """The (K,) per-worker exponential jitter scales (fractions of base)."""
        return self._vector(self.jitter, K, "jitter")

    @property
    def has_jitter(self) -> bool:
        """True when any worker's finish time is stochastic."""
        return bool(np.any(np.asarray(self.jitter) > 0))

    @staticmethod
    def _vector(x, K: int, what: str) -> np.ndarray:
        v = np.asarray(x, dtype=np.float64)
        if v.ndim == 0:
            return np.full(K, float(v), dtype=np.float64)
        if v.shape != (K,):
            raise ValueError(f"per-worker {what} has shape {v.shape}, need ({K},)")
        return v.copy()

    def sample(self, K: int, stragglers: Sequence[int], rng: np.random.Generator,
               *, stable: bool = False) -> np.ndarray:
        """One trial's (K,) finish times with ``stragglers`` slowed down.

        ``stable=True`` draws the exponential jitter by inverse-CDF over
        ``rng.random()`` uniforms (always K of them, even for zero-scale
        workers).  NumPy guarantees the raw uniform bitstream of a seeded
        ``Generator`` across versions but NOT its distribution methods, so
        this is the path recorded golden traces (the chaos harness) rely on
        for bit-reproducibility.
        """
        t = self.base_vector(K)
        t[list(stragglers)] *= self.straggler_slowdown
        if stable:
            scale = self.jitter_vector(K) * t
            u = rng.random(K)
            return t + np.where(scale > 0, -scale * np.log1p(-u), 0.0)
        if self.has_jitter:
            t = t + rng.exponential(self.jitter_vector(K) * t)
        return t


@dataclasses.dataclass(frozen=True)
class WorkerTimes:
    finish: np.ndarray  # (K,) seconds

    def completion_for_threshold(self, tau: int) -> float:
        """Latency until ANY tau workers have finished (async master)."""
        return float(np.sort(self.finish)[tau - 1])

    def survivors_at_threshold(self, tau: int) -> np.ndarray:
        """Worker ids of the first tau finishers (the decode survivor set)."""
        return np.argsort(self.finish, kind="stable")[:tau]

    def completion_with_mask(self, mask) -> float:
        """Latency of one SYNCHRONOUS step under a 0/1 survivor mask.

        The step waits for every non-erased worker (the mesh runtime has
        no partial barrier); erased workers are never waited
        on.  With a mask that erases exactly the K - tau slowest workers
        this equals ``completion_for_threshold(tau)``.
        """
        keep = np.asarray(mask).astype(bool)
        if keep.shape != self.finish.shape:
            raise ValueError(f"mask shape {keep.shape} != {self.finish.shape}")
        if not keep.any():
            raise ValueError("mask erases every worker: nothing to wait for")
        return float(self.finish[keep].max())

    def completion_with_progress(self, progress) -> float:
        """Latency of one step that consumes FRACTIONS of workers' tasks.

        ``progress[k]`` in [0, 1] is the share of worker k's task the step
        waits for (the partial-straggler sub-task prefix,
        ``runtime/partial.py``); a worker's prefix lands at
        ``progress_k * finish_k`` under the proportional-work law, so the
        step completes at ``max over progress_k > 0``.  A 0/1 progress
        vector reproduces ``completion_with_mask`` exactly.
        """
        w = np.asarray(progress, dtype=np.float64)
        if w.shape != self.finish.shape:
            raise ValueError(f"progress shape {w.shape} != {self.finish.shape}")
        if np.any(w < 0) or np.any(w > 1):
            raise ValueError(f"progress must lie in [0, 1], got {w.tolist()}")
        kept = w > 0
        if not kept.any():
            raise ValueError("zero progress everywhere: nothing to wait for")
        return float((w[kept] * self.finish[kept]).max())


def simulate_completion(
    K: int,
    tau: int,
    num_stragglers: int,
    model: Optional[LatencyModel],
    decode_time: float = 0.0,
    trials: int = 100,
    seed: int = 0,
    feed: Optional[TimeFeed] = None,
) -> np.ndarray:
    """Return per-trial completion latencies (paper Fig. 1 protocol).

    Each trial picks ``num_stragglers`` distinct random workers as
    stragglers.  If fewer than tau workers can ever finish (impossible here -
    stragglers still finish, just late) the job still completes; the latency
    jump at num_stragglers > K - tau is the interesting regime.

    ``feed`` overrides the parametric model with an injectable per-worker
    time source ``(trial, rng) -> (K,) seconds`` — recorded traces or a
    monitor-fitted model replay through the same protocol.
    """
    if model is None and feed is None:
        raise ValueError("need a LatencyModel or a time feed")
    rng = np.random.default_rng(seed)
    out = np.empty(trials)
    for t in range(trials):
        if feed is not None:
            finish = np.asarray(feed(t, rng), dtype=np.float64)
            if finish.shape != (K,):
                raise ValueError(f"feed returned shape {finish.shape}, need ({K},)")
        else:
            stragglers = rng.choice(K, size=num_stragglers, replace=False)
            finish = model.sample(K, stragglers, rng)
        out[t] = WorkerTimes(finish).completion_for_threshold(tau) + decode_time
    return out


def completion_cdf(latencies: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Empirical completion CDF: P[T <= t] for each t in ``ts``."""
    lat = np.sort(np.asarray(latencies, dtype=np.float64))
    return np.searchsorted(lat, np.asarray(ts, dtype=np.float64),
                           side="right") / max(lat.size, 1)


def completion_quantile(latencies: np.ndarray, q) -> np.ndarray:
    """Completion-latency quantile(s) (e.g. q=0.99 for a tail SLO)."""
    return np.quantile(np.asarray(latencies, dtype=np.float64), q)


def _masked_shifted_exp(model: LatencyModel, mask) -> tuple:
    """(kept per-worker shifts, kept per-worker Exp scales) under a weight
    vector.

    ``mask`` generalises from 0/1 to fractional work shares in [0, 1]
    (partial-straggler sub-task prefixes): a worker waited on for share
    ``w`` contributes ``w * (base + Exp(scale)) = w*base + Exp(w*scale)``
    — the same shifted-exponential family with both parameters scaled — so
    every closed-form consumer (CDF / quantile / mean) generalises for
    free.  A 0/1 mask reproduces the binary law exactly.
    """
    w = np.asarray(mask, dtype=np.float64)
    K = w.shape[0] if w.ndim == 1 else 0
    if w.ndim != 1 or K == 0:
        raise ValueError(
            f"mask must be a (K,) weight vector, got shape {np.shape(mask)}")
    if np.any(w < 0) or np.any(w > 1):
        raise ValueError(f"weights must lie in [0, 1], got {w.tolist()}")
    kept = w > 0
    if not kept.any():
        raise ValueError("mask erases every worker: nothing to wait for")
    base = model.base_vector(K)
    scale = model.jitter_vector(K) * base
    return base[kept] * w[kept], scale[kept] * w[kept]


def _product_cdf(base: np.ndarray, scale: np.ndarray, ts) -> np.ndarray:
    """P[max_i (base_i + Exp(scale_i)) <= t] for each t (vectorised)."""
    t = np.asarray(ts, dtype=np.float64)
    tt = np.atleast_1d(t)[:, None]                       # (T, 1) vs (kept,)
    with np.errstate(divide="ignore", invalid="ignore"):
        expo = np.where(scale > 0, (tt - base) / np.where(scale > 0, scale, 1.0),
                        np.inf)
    F = np.where(tt >= base, 1.0 - np.exp(-np.where(tt >= base, expo, 0.0)), 0.0)
    # zero-scale workers: unit step at base
    F = np.where(scale > 0, F, (tt >= base).astype(np.float64))
    out = F.prod(axis=1)
    return out if t.ndim else float(out[0])


def _quantile_from_cdf(base: np.ndarray, scale: np.ndarray, q: float) -> float:
    """Invert the product CDF by bisection (base/scale precomputed)."""
    lo = float(base.max())
    if q == 0.0 or not np.any(scale > 0):
        return lo
    if q == 1.0:
        return float(np.inf)
    # upper bracket: union bound — at t with every per-worker tail mass
    # <= (1-q)/n the product CDF is >= q.
    n = base.size
    tail = (1.0 - q) / n
    with np.errstate(divide="ignore"):
        hi = float(np.max(base + scale * (-np.log(tail))))
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _product_cdf(base, scale, mid) < q:
            lo = mid
        else:
            hi = mid
    return hi


def masked_completion_cdf(model: LatencyModel, mask, ts) -> np.ndarray:
    """Exact step-completion CDF under ``model`` with a 0/1 survivor mask.

    The synchronous step waits for every kept worker, whose finish times are
    independent shifted exponentials ``base_i + Exp(scale_i)``, so

        P[T <= t] = prod over kept i of F_i(t),
        F_i(t)    = 1 - exp(-(t - base_i) / scale_i)   for t >= base_i

    (a unit step at ``base_i`` when ``scale_i == 0``).  This is the
    tau-th-order-statistic law of the paper's latency model, specialised to
    the mask that erases the ``K - tau`` flagged stragglers.  ``mask`` may
    also carry fractional work shares in [0, 1] (partial-straggler
    prefixes): share ``w`` scales both the shift and the Exp scale by
    ``w``, staying inside the same product-of-shifted-exponentials law.
    """
    base, scale = _masked_shifted_exp(model, mask)
    return _product_cdf(base, scale, ts)


def masked_completion_quantile(model: LatencyModel, mask, q: float) -> float:
    """Closed-form q-quantile of masked step completion under ``model``.

    Inverts ``masked_completion_cdf`` by bisection (the CDF is a product of
    shifted-exponential factors — monotone, no closed inverse for
    heterogeneous workers).  Edge cases: ``q == 0`` returns the essential
    minimum ``max(kept base)``; ``q == 1`` returns ``inf`` whenever any kept
    worker has jitter (the shifted exponential is unbounded), else
    ``max(kept base)``.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q={q} outside [0, 1]")
    base, scale = _masked_shifted_exp(model, mask)
    return _quantile_from_cdf(base, scale, q)


def masked_completion_mean(model: LatencyModel, mask) -> float:
    """Closed-form mean of masked step completion under ``model``.

    ``E[max] = lo + integral over (lo, hi) of (1 - F(t)) dt`` with ``lo``
    the essential minimum and ``hi`` the 1-1e-6 quantile (the truncated
    exponential tail beyond it contributes O(scale * 1e-6)); the integral
    is a trapezoid over the vectorised product CDF.
    """
    base, scale = _masked_shifted_exp(model, mask)
    lo = float(base.max())
    if not np.any(scale > 0):
        return lo
    hi = _quantile_from_cdf(base, scale, 1.0 - 1e-6)
    ts = np.linspace(lo, hi, 513)
    survival = 1.0 - _product_cdf(base, scale, ts)
    # np.trapz was renamed np.trapezoid in numpy 2.0; support both
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return lo + float(trapezoid(survival, ts))


def measure_worker_time(fn: Callable[[], object], repeats: int = 3) -> float:
    """Wall-time one worker's compute (median of ``repeats`` runs).

    Where CUDA is in use, the card is synchronized before the clock starts
    and after ``fn`` returns, so each time covers the device work that
    ``fn`` queued and nothing queued before it.
    """
    times = []
    for _ in range(repeats):
        _cuda_sync()
        t0 = time.perf_counter()
        fn()
        _cuda_sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _cuda_sync() -> None:
    """Wait for the card's queued work (no-op until CUDA is initialised)."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
