"""Progress planning: how much work to consume from flagged stragglers.

The binary control plane erases a flagged worker outright — the step then
never waits on it.  With sub-tasking (``runtime/partial.py``) there is a
middle ground: ask a flagged worker for a PREFIX of its chunks, paying
``q/Q`` of its (slow) finish time for ``q/Q`` of its coded rows.

Two planners share the same contract (healthy workers at full Q, every
chunk covered tau times, progress in multiples of 1/Q):

``method="lp"`` (default) solves the bottleneck LP exactly::

    minimise   W = max_k (counts_k / Q) * mean_k
    subject to coverage(counts)_c >= tau  for every chunk c,
               counts_k = Q for healthy k,  0 <= counts_k <= Q.

The objective is a min-max, so the LP collapses to a one-dimensional
parametric feasibility problem: for a wait bound T the best counts are the
caps ``counts_k = floor(T * Q / mean_k)`` (clipped to Q), coverage is
monotone non-decreasing in T, and the optimum is the smallest T in the
finite candidate set {q/Q * mean_k} U {max healthy mean} whose caps span.
A reverse-greedy trim then drops chunks the bound does not need, so the
plan also consumes as little straggler work as the optimal wait allows.
This is provably never worse than greedy: greedy's achieved wait is itself
a feasible candidate bound, and the scan returns the smallest one.

``method="greedy"`` is the legacy worst-chunk repair: start from the
binary mask and raise the flagged worker minimising the resulting wait
``(counts_k + need) / Q * mean_k`` until no chunk is undercovered.  Kept
for comparison and for the never-worse regression property.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.runtime.partial import chunk_coverage

__all__ = ["plan_partial_progress", "expected_wait"]


def expected_wait(progress, mean_s) -> float:
    """Modelled step wait of a progress plan: ``max_k progress_k * mean_k``.

    The cost model both planners optimise — worker k delivers its prefix
    after ``progress_k`` of its mean step latency, and the step waits for
    the slowest consumed prefix.
    """
    p = np.asarray(progress, dtype=np.float64)
    m = np.asarray(mean_s, dtype=np.float64)
    if p.size == 0:
        return 0.0
    return float(np.max(p * m))


def _greedy_counts(mean: np.ndarray, ids: list, Q: int, tau: int,
                   K: int) -> np.ndarray:
    """Legacy worst-chunk repair (see module docstring)."""
    counts = np.full(K, Q, dtype=np.int64)
    counts[ids] = 0
    while True:
        cov = chunk_coverage(counts, Q)
        deficient = np.flatnonzero(cov < tau)
        if not deficient.size:
            break
        # repair the worst-covered chunk first
        c = int(deficient[np.argmin(cov[deficient])])
        best_k, best_need, best_wait = -1, 0, np.inf
        for k in range(K):
            d = (c - k) % Q  # chunk c is worker k's (d+1)-th sub-task
            if counts[k] > d:
                continue  # already covers chunk c
            need = d + 1 - counts[k]
            wait = (counts[k] + need) / Q * mean[k]
            if wait < best_wait:
                best_k, best_need, best_wait = k, need, wait
        # a candidate always exists while cov[c] < tau <= K: any worker not
        # covering chunk c can be extended to it.
        counts[best_k] += best_need
    return counts


def _trim_counts(counts: np.ndarray, ids: list, mean: np.ndarray, Q: int,
                 tau: int) -> np.ndarray:
    """Drop flagged chunks the coverage constraint does not need.

    Most-expensive flagged workers first; each decrement removes exactly
    chunk ``(k + counts_k - 1) % Q`` (the last sub-task of k's cyclic
    prefix), so feasibility is maintained chunk-locally.  Never raises any
    worker's wait, so the bottleneck objective is untouched.
    """
    cov = chunk_coverage(counts, Q)
    for k in sorted(ids, key=lambda i: -mean[i]):
        while counts[k] > 0:
            c = (k + counts[k] - 1) % Q
            if cov[c] <= tau:
                break
            counts[k] -= 1
            cov[c] -= 1
    return counts


def _lp_counts(mean: np.ndarray, ids: list, Q: int, tau: int,
               K: int) -> np.ndarray:
    """Exact bottleneck-LP solve via parametric feasibility (docstring)."""
    healthy = np.ones(K, dtype=bool)
    healthy[ids] = False
    base = np.zeros(K, dtype=np.int64)
    base[healthy] = Q
    # Candidate bounds: every flagged prefix wait, plus the healthy pool's
    # own wait (the floor no plan with full healthy workers can beat).
    cands = {float(np.max(mean[healthy]))} if healthy.any() else set()
    for k in ids:
        for q in range(1, Q + 1):
            cands.add(q / Q * float(mean[k]))
    for T in sorted(cands):
        counts = base.copy()
        for k in ids:
            counts[k] = min(Q, int(np.floor(T * Q / mean[k] + 1e-9)))
        if np.all(chunk_coverage(counts, Q) >= tau):
            return _trim_counts(counts, ids, mean, Q, tau)
    # unreachable: at the largest candidate every cap is Q, so every chunk
    # has K >= tau contributors (tau <= K is validated by the caller).
    raise AssertionError("bottleneck scan found no feasible bound")


def plan_partial_progress(mean_s, flagged: Sequence[int], Q: int,
                          tau: int, method: str = "lp") -> np.ndarray:
    """Per-worker progress plan in [0, 1] covering every chunk tau times.

    Args:
        mean_s: (K,) per-worker mean step latencies (the monitor's EWMA) —
            the cost model for choosing WHICH straggler's chunks to consume.
        flagged: worker ids the monitor would erase (start at 0 chunks;
            healthy workers run all Q).
        Q: sub-task count per worker.
        tau: the active rung's recovery threshold.
        method: ``"lp"`` (default) for the exact bottleneck-LP solve,
            ``"greedy"`` for the legacy worst-chunk repair.  The LP plan's
            expected wait (:func:`expected_wait`) is never worse than
            greedy's: greedy's achieved wait is a feasible bound in the
            LP's candidate scan, which returns the smallest feasible one.

    Returns:
        (K,) progress vector, multiples of ``1/Q``.  Equals the binary
        erasure mask whenever the healthy pool alone spans the system.

    Raises:
        ValueError: on a bad shape/ids, non-positive means, an unknown
            ``method``, or ``tau > K`` (no progress assignment can cover a
            chunk tau times).
    """
    mean = np.asarray(mean_s, dtype=np.float64)
    if mean.ndim != 1 or mean.size == 0:
        raise ValueError(f"mean_s must be a (K,) vector, got {np.shape(mean_s)}")
    K = mean.shape[0]
    if not np.all(np.isfinite(mean)) or np.any(mean <= 0):
        raise ValueError(f"per-worker means must be positive, got {mean.tolist()}")
    if Q < 1:
        raise ValueError(f"need Q >= 1 sub-tasks, got {Q}")
    if tau > K:
        raise ValueError(f"tau={tau} > K={K}: no plan can span the system")
    ids = [int(i) for i in flagged]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate worker ids in flagged: {ids}")
    for i in ids:
        if not 0 <= i < K:
            raise ValueError(f"flagged id {i} out of range for K={K}")
    if method == "lp":
        counts = _lp_counts(mean, ids, Q, tau, K)
    elif method == "greedy":
        counts = _greedy_counts(mean, ids, Q, tau, K)
    else:
        raise ValueError(f"unknown method {method!r}; options: lp, greedy")
    return counts.astype(np.float64) / Q
