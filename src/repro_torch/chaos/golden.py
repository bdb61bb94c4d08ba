"""The canonical deterministic runs behind ``tests/golden/*.jsonl``.

One fixed recipe — ladder geometry, shapes, request operands, policy
seeds, CONSTANT per-rung overheads (prewarm's MEASURED overheads carry
wall-clock noise, so golden runs must not rank by them) — applied to each
catalog entry.  ``tests/test_chaos.py`` re-runs the recipe and asserts the
recorded trace matches the checked-in golden file bit-for-bit;
``scripts/regen_golden_traces.py`` rewrites the files after an INTENDED
control-plane behaviour change (the diff then documents exactly what
changed).

Catalog: every registered scenario under its own name, plus
``pareto_feedback`` — the Pareto-tail regime served WITH observed-
violation feedback, so the feedback control law itself is pinned by a
golden trace too — ``crawler_partial`` — the crawler regime served with
``sub_tasks=4``, pinning the fractional progress plans partial decoding
emits — and the ELASTIC pair ``pool_resize_shrink`` / ``pool_resize_grow``
— the pool_resize regime served through an elastic ``AdaptiveServer``
(``universe=``), pinning the executed shrink handoff (departures exceed
the polycode-only ladder's slack, the pool re-lowers onto the survivors)
and, in the grow variant, the subsequent admission of the arriving
workers onto Leja-extended evaluation points.

This is the JAX package's recipe (``repro.chaos.golden``), and the port
reproduces the files it wrote.  The port's ladder runs on a device and a
backend: ``golden_trace``/``replay_golden`` take ``device=`` (default the
CUDA card, as every entry point of the port) and ``backend=`` (default
``"reference"``, as in the recipe).  Every recorded field is a function of
the feed alone, so no backend or device may move one of them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.chaos.scenarios import make_scenario, scenario_names
from repro_torch.chaos.trace import Trace, TraceRecorder

__all__ = ["GOLDEN_GRID", "GOLDEN_K", "GOLDEN_L", "GOLDEN_SHAPES",
           "GOLDEN_STEPS", "GOLDEN_SEED", "GOLDEN_OVERHEAD_S",
           "golden_names", "golden_trace", "replay_golden"]

GOLDEN_GRID = (4, 2, 1)          # rungs bec(tau=2), tradeoff p'=2(5), polycode(11)
GOLDEN_K = 12
GOLDEN_L = 257                   # every rung feasible in float64
GOLDEN_SHAPES = ((16, 8), (16, 4))
GOLDEN_STEPS = 10
GOLDEN_SEED = 7
#: deterministic per-rung step costs (units of one worker step) — the
#: depth-p digit stack prices the low-tau rungs, so the mean ranking
#: genuinely moves across regimes instead of parking on the widest budget.
GOLDEN_OVERHEAD_S = {"bec": 2.0, "tradeoff(p'=2)": 1.0, "polycode": 0.1}
_SLO_QUANTILE = 0.99
_SLO_S = 4.0                     # bound the predictive fallback is judged by
_FEEDBACK_SLO_S = 2.5            # tighter bound for the feedback variant
_PARTIAL_SUB_TASKS = 4           # Q of the crawler_partial variant

#: the elastic pool_resize pair: a polycode-only ladder (narrow budget, so
#: three departures exceed slack and force the EXECUTED handoff) on a grid
#: whose bec rung (tau=2) still fits the shrunk pool — the paper's L<->tau
#: tradeoff is what keeps the survivors decodable.
_ELASTIC_KEYS = ("pool_resize_shrink", "pool_resize_grow")
_ELASTIC_GRID = (3, 2, 1)        # bec(tau=2), polycode(tau=8)
_ELASTIC_UNIVERSE = 12           # fleet size the feed emits for
_ELASTIC_K = 10                  # initial pool: universe minus the arrivals
_ELASTIC_STEPS = 16
_ELASTIC_DEPART_STEP = 4
_ELASTIC_JOIN_STEP = 12          # grow variant only
_ELASTIC_OVERHEAD_S = {"bec": 2.0, "polycode": 0.1}


def golden_names() -> Tuple[str, ...]:
    """Catalog keys: every scenario + feedback/partial/elastic variants."""
    return scenario_names() + ("pareto_feedback",
                               "crawler_partial") + _ELASTIC_KEYS


def _elastic_scenario(key: str):
    """The pool_resize variant behind an elastic catalog ``key``."""
    return make_scenario(
        "pool_resize", num_departing=3, depart_step=_ELASTIC_DEPART_STEP,
        num_arriving=2,
        join_step=_ELASTIC_JOIN_STEP if key == "pool_resize_grow" else None)


def _request(dtype, device):
    """Deterministic integer operands (no rng: stable across versions)."""
    (v, r), (_, t) = GOLDEN_SHAPES
    A = torch.as_tensor(np.arange(v * r).reshape(v, r) % 5 - 2, dtype=dtype,
                        device=device)
    B = torch.as_tensor(np.arange(v * t).reshape(v, t) % 5 - 2, dtype=dtype,
                        device=device)
    return A, B


def _serve(key: str, feed, steps: int, seed: int = GOLDEN_SEED, *,
           device=None, backend: str = "reference"):
    """Run the canonical server config for ``key`` over ``feed``."""
    from repro_torch.control import (
        AdaptiveServer,
        ExpectedLatencyPolicy,
        PlanLadder,
    )

    if key in _ELASTIC_KEYS:
        scenario = _elastic_scenario(key)
        arriving = scenario.arriving_ids(_ELASTIC_UNIVERSE, seed)
        absent = set(int(i) for i in arriving)
        pool = [i for i in range(_ELASTIC_UNIVERSE) if i not in absent]
        p, m, n = _ELASTIC_GRID
        ladder = PlanLadder(p, m, n, K=_ELASTIC_K, L=GOLDEN_L,
                            backend=backend, dtype=torch.float64,
                            device=device, include=["polycode"])
        ladder.prewarm(*GOLDEN_SHAPES)
        policy = ExpectedLatencyPolicy(ladder,
                                       overhead_s=_ELASTIC_OVERHEAD_S)
        server = AdaptiveServer(ladder, policy=policy, feed=feed,
                                check_exact=True,
                                universe=_ELASTIC_UNIVERSE, pool=pool)
        A, B = _request(torch.float64, ladder.device)
        for i in range(steps):
            if scenario.join_step is not None and i == scenario.join_step:
                server.grow(arriving)
            server.step(A, B)
        return server.reports

    feedback = key == "pareto_feedback"
    sub_tasks = _PARTIAL_SUB_TASKS if key == "crawler_partial" else 1
    p, m, n = GOLDEN_GRID
    ladder = PlanLadder(p, m, n, K=GOLDEN_K, L=GOLDEN_L,
                        backend=backend, dtype=torch.float64, device=device)
    ladder.prewarm(*GOLDEN_SHAPES, sub_tasks=sub_tasks)
    policy = ExpectedLatencyPolicy(ladder, overhead_s=GOLDEN_OVERHEAD_S,
                                   sub_tasks=sub_tasks)
    server = AdaptiveServer(
        ladder, policy=policy, feed=feed, check_exact=True,
        slo_quantile=_SLO_QUANTILE,
        slo_s=_FEEDBACK_SLO_S if feedback else _SLO_S,
        feedback=feedback, sub_tasks=sub_tasks)
    A, B = _request(torch.float64, ladder.device)
    return server.run(steps, lambda i: (A, B))


def golden_trace(key: str, steps: Optional[int] = None,
                 seed: int = GOLDEN_SEED, *, device=None,
                 backend: str = "reference") -> Trace:
    """Run the canonical recipe for catalog entry ``key`` and record it.

    ``steps`` defaults to ``GOLDEN_STEPS`` (``_ELASTIC_STEPS`` for the
    elastic pair, whose grow event lands at step ``_ELASTIC_JOIN_STEP``).
    ``device``/``backend`` choose where the ladder serves (default: the
    CUDA card, the plain reference backend).

    Raises:
        KeyError: for a key outside :func:`golden_names`.
    """
    if key not in golden_names():
        raise KeyError(f"unknown golden key {key!r}; have {golden_names()}")
    if key in _ELASTIC_KEYS:
        if steps is None:
            steps = _ELASTIC_STEPS
        scenario = _elastic_scenario(key)
        recorder = TraceRecorder(
            scenario.compile(_ELASTIC_UNIVERSE, seed=seed), _ELASTIC_UNIVERSE,
            meta={"scenario": "pool_resize", "seed": seed, "steps": steps,
                  "grid": list(_ELASTIC_GRID), "L": GOLDEN_L,
                  "elastic": True, "universe": _ELASTIC_UNIVERSE,
                  "include": ["polycode"],
                  "join_step": scenario.join_step})
        reports = _serve(key, recorder, steps, seed=seed, device=device,
                         backend=backend)
        return recorder.finish(reports)
    if steps is None:
        steps = GOLDEN_STEPS
    feedback = key == "pareto_feedback"
    scenario_name = {"pareto_feedback": "pareto",
                     "crawler_partial": "crawler"}.get(key, key)
    scenario = make_scenario(scenario_name)
    recorder = TraceRecorder(
        scenario.compile(GOLDEN_K, seed=seed), GOLDEN_K,
        meta={"scenario": scenario_name, "seed": seed, "steps": steps,
              "grid": list(GOLDEN_GRID), "L": GOLDEN_L,
              "feedback": feedback,
              "sub_tasks": (_PARTIAL_SUB_TASKS
                            if key == "crawler_partial" else 1)})
    reports = _serve(key, recorder, steps, seed=seed, device=device,
                     backend=backend)
    return recorder.finish(reports)


def replay_golden(key: str, trace: Trace, *, device=None,
                  backend: str = "reference"):
    """Re-serve ``trace`` through a FRESH canonical server; the reports
    must reproduce the trace bit-exactly (``trace.diff(...) == []``).

    ``device``/``backend`` as for :func:`golden_trace`: a checked-in
    golden file replays on any backend with an empty diff."""
    if key not in golden_names():
        raise KeyError(f"unknown golden key {key!r}; have {golden_names()}")
    return _serve(key, trace.feed(), len(trace.steps),
                  seed=int(trace.meta.get("seed", GOLDEN_SEED)),
                  device=device, backend=backend)
