"""Control-plane bench on the port: static best rung vs adaptive, swept over
stragglers.

The twin of ``benchmarks/control_bench.py`` over ``repro_torch.control``
and ``repro_torch.chaos``: the same sweeps, constants and ``--check`` gates,
importing only the port.  The serving model is the synchronous step: a step
waits for every worker that is not declared erased, so a *static* rung
(no health monitor) completes at the max over ALL workers, while the
*adaptive* control plane learns the straggler set and erases it within the
active rung's budget ``K - tau``.  Every adaptive step also serves a real
coded matmul through the ladder's facades, checked exact against the
uncoded oracle on the device; the facade's own
``runtime.executable.compile`` counter (``CompileWatch``) proves rung
switches after ``prewarm()`` build nothing.

Sweeps (as in the reference): ``regimes`` (L x straggler count),
``quantile_sweep`` (mean vs p99 policy on batched requests through
prewarmed buckets), ``scenario_sweep`` (every registered chaos scenario,
stressed and calm), ``feedback_sweep`` (static-q vs observed-violation
feedback), ``partial_sweep`` (binary erasure vs ``sub_tasks=4``),
``elastic_sweep`` (executed shrink, then grow) and ``exhausted`` (the
budget-exhaustion handoff).

Usage::

    python -m benchmarks.torch_control_bench --check                 # card, reference
    python -m benchmarks.torch_control_bench --check --backend fused # the kernels
    python -m benchmarks.torch_control_bench --check --device cpu    # plain, on the CPU
    python -m benchmarks.torch_control_bench elastic_sweep --check --out rows.json
    python -m benchmarks.torch_control_bench partial_sweep --backend mesh --check --device cpu

``--backend`` is the ladder's backend (reference, fused, staged, or mesh).
``partial_sweep --backend mesh`` replays the strict-win scenarios
(heavy_tail, pareto) on a (1, K) mesh of K = 12 ranks that
``launch/mesh.py`` spawns, each rank serving through a ``MeshExecutor``
(plain PyTorch worker products on the CPU, the CUDA kernels on the card),
with rows under ``partial_sweep_mesh`` as in the reference; its ``--check``
also holds the rows equal to ``BENCH_control.json``'s.  The JSON rows go
only to the path given by ``--out``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from benchmarks.torch_obs_util import CompileWatch, assert_no_recompiles
from repro_torch.chaos import make_scenario, scenario_names, trace_matrix
from repro_torch.control import (
    AdaptiveServer,
    ExpectedLatencyPolicy,
    FeedbackConfig,
    PlanLadder,
    QuantileLatencyPolicy,
)
from repro_torch.core.simulator import LatencyModel
from repro_torch.runtime import MeshExecutor

# geometry shared by every rung of the ladder (paper Sec. IV family)
P, M, N, K = 4, 2, 1, 12
V, R, T = 16, 8, 4
STEPS = 24
RESAMPLE_EVERY = 8
BASE_S = 1.0
SLOWDOWN = 2.0
JITTER = 0.02
L_SMALL = V * 4 * 4 + 1     # conservative_L(V, 4, 4): every rung feasible
L_LARGE = 1 << 14           # bec's depth-3 digit stack overflows f64 here
STRAGGLER_COUNTS = (0, 1, 3, 5)

# -- p50-vs-p99 policy sweep ------------------------------------------------
Q_STEPS = 48
Q_WARMUP = 6                # cold-monitor steps excluded from the stats
Q_SLO = 0.99
HEAVY_JITTER = 1.5          # stragglers: 2x slowdown + Exp(1.5 x base) tail
HEALTHY_JITTER = 0.05
# synthetic per-rung step cost (units of BASE_S): the depth-p digit stack
# prices the low-tau rungs, the paper's L <-> tau tradeoff as overhead
Q_OVERHEAD = {"bec": 10.0, "tradeoff(p'=2)": 9.0, "polycode": 0.5}
Q_STRAGGLERS = (0, 3, 5)
Q_BATCHES = (5, 3, 8, 2)    # per-request batch sizes, cycled
Q_BUCKETS = (4, 8)          # prewarmed leading-dim buckets (round-up pad)

# -- registered-scenario sweep ------------------------------------------------
SC_STEPS = 24
SC_SEED = 5

# -- partial-straggler sweep (binary erasure vs sub-task consumption) ---------
PARTIAL_SCENARIOS = ("heavy_tail", "pareto", "crawler", "degrading")
PARTIAL_SUB_TASKS = 4
PARTIAL_STEPS = 48
PARTIAL_WARMUP = 6
PARTIAL_SEED = 11
# the mesh gate replays only the strict-win regimes (the reference's)
PARTIAL_MESH_SCENARIOS = ("heavy_tail", "pareto")
MESH_TIMEOUT_S = 600
BENCH_FILE = Path(__file__).resolve().parents[1] / "BENCH_control.json"

# -- elastic shrink/grow sweep ------------------------------------------------
EL_GRID = (3, 2, 1)         # bec(tau=2) + polycode(tau=8); 3 prime, no tradeoff
EL_UNIVERSE = 12
EL_STEPS = 24
EL_DEPART = 4               # 3 departures > the polycode-only budget of 2
EL_JOIN = 14                # the 2 absent workers join here
EL_SEED = 7
#: constant per-rung step costs: the grow gate is that readmitting the
#: joiners wins back polycode's cheap digit stack (0.1 vs bec's 2.0).
EL_OVERHEAD = {"bec": 2.0, "polycode": 0.1}

# -- observed-violation feedback sweep ---------------------------------------
FB_STEPS = 96
FB_WARMUP = 8
FB_Q_BASE = 0.8             # deliberately understated: predictions look safe
FB_SLO_S = 12.0
FB_SEEDS = (37, 51)
FB_CONFIG = dict(gain=8.0, window=32, force_after=2, target_rate=0.01)

BACKENDS = ("reference", "fused", "staged", "mesh")


def ladder_kw(backend: str = "reference", device=None, mesh=None) -> dict:
    """The ``PlanLadder`` keywords every sweep serves through; on "mesh",
    this rank's ``MeshExecutor`` over ``mesh`` (plain worker products and
    decode on a CPU mesh, the kernels on a card, as the reference uses
    plain ones off the TPU).

    Raises:
        ValueError: for an unknown backend, or "mesh" without a mesh.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options {BACKENDS}")
    if backend == "mesh":
        if mesh is None:
            raise ValueError("the mesh backend needs the rank's mesh")
        return {"backend": MeshExecutor(mesh, use_kernels=mesh.device_type != "cpu"),
                "device": device, "mesh": mesh}
    return {"backend": backend, "device": device}


def _backend_name(lad: dict) -> str:
    backend = lad["backend"]
    return backend if isinstance(backend, str) else backend.name


def _operands(seed: int, device, a_shape=(V, R)):
    """Integer operands in [-4, 4] from ``seed`` (the reference's draws)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(-4, 5, size=a_shape)
    B = rng.integers(-4, 5, size=(V, T))
    return (torch.as_tensor(A, dtype=torch.float64, device=device),
            torch.as_tensor(B, dtype=torch.float64, device=device))


def _rung_counts(reports) -> dict:
    counts: dict = {}
    for rep in reports:
        counts[rep.rung] = counts.get(rep.rung, 0) + 1
    return counts


def _traces(S: int, seed: int) -> np.ndarray:
    """(STEPS, K) per-worker finish times: persistent straggler set of size
    S, resampled every RESAMPLE_EVERY steps (the paper's 2x duplication
    model plus light exponential jitter)."""
    rng = np.random.default_rng(seed)
    model = LatencyModel(base=BASE_S, straggler_slowdown=SLOWDOWN,
                         jitter=JITTER)
    out = np.empty((STEPS, K))
    slow = rng.choice(K, size=S, replace=False)
    for step in range(STEPS):
        if step and step % RESAMPLE_EVERY == 0:
            slow = rng.choice(K, size=S, replace=False)
        out[step] = model.sample(K, slow, rng)
    return out


def _run_regime(L: int, S: int, seed: int, lad: dict) -> dict:
    traces = _traces(S, seed)
    watch = CompileWatch()
    ladder = PlanLadder(P, M, N, K=K, L=L, **lad)
    ladder.prewarm((V, R), (V, T))
    watch.mark()
    # uniform zero overhead: rungs differ only through masking/feasibility,
    # so the sweep is deterministic given the seeds.
    policy = ExpectedLatencyPolicy(
        ladder, overhead_s={r: 0.0 for r in ladder.rungs})
    server = AdaptiveServer(ladder, policy=policy,
                            feed=lambda step, rng: traces[step],
                            seed=seed, check_exact=True)
    A, B = _operands(seed + 1, ladder.device)
    reports = server.run(STEPS, lambda i: (A, B))

    static_s = {r: float(traces.max(axis=1).mean()) for r in ladder.rungs}
    info = ladder.cache_info()
    return {
        "L": L,
        "stragglers": S,
        "static_s": static_s,
        "static_feasible": {r: policy.feasible(r) for r in ladder.rungs},
        "adaptive_s": float(np.mean([rep.sim_latency_s for rep in reports])),
        "adaptive_rungs": _rung_counts(reports),
        "switches": info["switches"],
        "recompiles": watch.delta(),
        "panel_builds": info["panel_builds"],
        "respecializations": sum(rep.respecialize for rep in reports),
        "all_exact": all(rep.exact for rep in reports),
    }


def _heavy_traces(S: int, steps: int, seed: int) -> np.ndarray:
    """(steps, K) finish times under the heavy-tailed straggler mix: a FIXED
    set of S machines at 2x slowdown with an Exp(HEAVY_JITTER x base) tail,
    everyone else near-deterministic."""
    rng = np.random.default_rng(seed)
    slow = rng.choice(K, size=S, replace=False)
    jitter = np.full(K, HEALTHY_JITTER)
    jitter[slow] = HEAVY_JITTER
    model = LatencyModel(base=BASE_S, straggler_slowdown=SLOWDOWN,
                         jitter=jitter)
    return np.stack([model.sample(K, slow, rng) for _ in range(steps)])


def _run_policy(policy_name: str, traces: np.ndarray, seed: int,
                lad: dict) -> dict:
    """One policy serving batched requests over ``traces``; realized step
    latency = masked completion + the rung's synthetic overhead."""
    watch = CompileWatch()
    ladder = PlanLadder(P, M, N, K=K, L=L_SMALL, **lad)
    ladder.prewarm((V, R), (V, T), batch_sizes=Q_BUCKETS)
    watch.mark()
    if policy_name == "mean":
        policy = ExpectedLatencyPolicy(ladder, overhead_s=Q_OVERHEAD)
    else:
        policy = QuantileLatencyPolicy(ladder, q=Q_SLO, overhead_s=Q_OVERHEAD)
    server = AdaptiveServer(ladder, policy=policy,
                            feed=lambda step, rng: traces[step],
                            seed=seed, check_exact=True)
    A_pool, B = _operands(seed + 1, ladder.device,
                          a_shape=(max(Q_BATCHES), V, R))
    reports = server.run(Q_STEPS,
                         lambda i: (A_pool[: Q_BATCHES[i % len(Q_BATCHES)]], B))

    realized = np.array([rep.sim_latency_s + Q_OVERHEAD[rep.rung]
                         for rep in reports])[Q_WARMUP:]
    info = ladder.cache_info()
    return {
        "policy": policy_name,
        "p50_s": float(np.quantile(realized, 0.5)),
        "p99_s": float(np.quantile(realized, Q_SLO)),
        "rungs": _rung_counts(reports[Q_WARMUP:]),
        "switches": info["switches"],
        "recompiles": watch.delta(),
        "all_exact": all(rep.exact for rep in reports),
    }


def _run_quantile_sweep(lad: dict) -> list:
    """Mean vs quantile policy over identical heavy-tailed batched traces."""
    rows = []
    for S in Q_STRAGGLERS:
        traces = _heavy_traces(S, Q_STEPS, seed=101 + S)
        for policy_name in ("mean", "quantile"):
            row = _run_policy(policy_name, traces, seed=101 + S, lad=lad)
            row["stragglers"] = S
            rows.append(row)
    return rows


def _run_scenario(name: str, seed: int, lad: dict) -> dict:
    """Static vs adaptive under one registered chaos scenario, stressed and
    in its ``calm()`` control, over the SAME trace matrix on both sides."""
    row: dict = {"scenario": name, "seed": seed}
    for variant in ("stressed", "calm"):
        scenario = make_scenario(name)
        if variant == "calm":
            scenario = scenario.calm()
        traces = trace_matrix(scenario, K, SC_STEPS, seed=seed)
        watch = CompileWatch()
        ladder = PlanLadder(P, M, N, K=K, L=L_SMALL, **lad)
        ladder.prewarm((V, R), (V, T))
        watch.mark()
        policy = ExpectedLatencyPolicy(
            ladder, overhead_s={r: 0.0 for r in ladder.rungs})
        server = AdaptiveServer(ladder, policy=policy,
                                feed=lambda step, rng: traces[step],
                                seed=seed, check_exact=True)
        A, B = _operands(seed + 1, ladder.device)
        reports = server.run(SC_STEPS, lambda i: (A, B))
        row[variant] = {
            "static_s": float(traces.max(axis=1).mean()),
            "adaptive_s": float(np.mean([r.sim_latency_s for r in reports])),
            "erasures": int(sum(len(r.erased) for r in reports)),
            "respecializations": int(sum(r.respecialize for r in reports)),
            "recompiles": watch.delta(),
            "all_exact": all(r.exact for r in reports),
        }
    return row


def _run_scenario_sweep(lad: dict) -> list:
    """Every registered scenario, stressed + calm control."""
    return [_run_scenario(name, seed=SC_SEED, lad=lad)
            for name in scenario_names()]


def _serve_partial(traces: np.ndarray, sub_tasks: int, seed: int, lad: dict):
    """One server (binary when ``sub_tasks=1``) over a fixed trace matrix.

    Returns ``(row, reports, ladder, (A, B))`` so the caller can run the
    Q=1 bit-parity check against the same facades and operands.
    """
    watch = CompileWatch()
    ladder = PlanLadder(P, M, N, K=K, L=L_SMALL, **lad)
    ladder.prewarm((V, R), (V, T), sub_tasks=sub_tasks)
    watch.mark()
    policy = ExpectedLatencyPolicy(ladder, overhead_s=Q_OVERHEAD,
                                   sub_tasks=sub_tasks)
    server = AdaptiveServer(ladder, policy=policy,
                            feed=lambda step, rng: traces[step],
                            seed=seed, check_exact=True, sub_tasks=sub_tasks)
    A, B = _operands(seed + 1, ladder.device)
    reports = server.run(len(traces), lambda i: (A, B))

    realized = np.array([r.sim_latency_s + Q_OVERHEAD[r.rung]
                         for r in reports])[PARTIAL_WARMUP:]
    fractions = sum(1 for r in reports[PARTIAL_WARMUP:]
                    if r.progress is not None
                    for x in r.progress if 0.0 < x < 1.0)
    row = {
        "sub_tasks": sub_tasks,
        "p50_s": float(np.quantile(realized, 0.5)),
        "p99_s": float(np.quantile(realized, Q_SLO)),
        "mean_s": float(realized.mean()),
        "fractional_consumptions": fractions,
        "rungs": _rung_counts(reports[PARTIAL_WARMUP:]),
        "recompiles": watch.delta(),
        "all_exact": all(r.exact for r in reports),
    }
    return row, reports, ladder, (A, B)


def _q1_parity(ladder, A, B, binary_reports) -> bool:
    """Every mask the binary run emitted, replayed through the Q=1 partial
    path (``progress`` vector + ``sub_tasks=1``): the decoded products must
    be BIT-IDENTICAL to the mask path."""
    for rung, erased in sorted({(r.rung, r.erased) for r in binary_reports}):
        ladder.switch(rung)  # a mask is only decodable on the rung that cut it
        progress = np.ones(K)
        progress[list(erased)] = 0.0
        legacy = ladder(A, B, erased=list(erased))
        partial = ladder(A, B, progress=progress, sub_tasks=1)
        if not torch.equal(legacy, partial):
            return False
    return True


def _run_partial(name: str, seed: int, lad: dict) -> dict:
    """Binary erasure vs partial consumption under one chaos scenario."""
    traces = trace_matrix(make_scenario(name), K, PARTIAL_STEPS, seed=seed)
    binary, binary_reports, ladder, (A, B) = _serve_partial(traces, 1, seed,
                                                            lad)
    partial, _, _, _ = _serve_partial(traces, PARTIAL_SUB_TASKS, seed, lad)
    return {"scenario": name, "seed": seed, "backend": _backend_name(lad),
            "binary": binary, "partial": partial,
            "q1_bit_identical": _q1_parity(ladder, A, B, binary_reports)}


def _run_partial_sweep(lad: dict) -> list:
    """Binary vs partial over the backend's partial-regime scenarios."""
    names = (PARTIAL_MESH_SCENARIOS if _backend_name(lad) == "mesh"
             else PARTIAL_SCENARIOS)
    return [_run_partial(name, seed=PARTIAL_SEED, lad=lad) for name in names]


def _mesh_partial_rank(mesh, device) -> list:
    """One rank's partial sweep on the mesh backend (every rank runs it)."""
    return _run_partial_sweep(ladder_kw("mesh", device, mesh))


def _run_mesh_partial_sweep(device) -> list:
    """The partial sweep on a (1, K) mesh of spawned ranks: rank 0's rows,
    after checking every rank made the same decisions."""
    from repro_torch.launch.mesh import spawn_mesh

    outs = spawn_mesh(_mesh_partial_rank, data=1, model=K, device=device,
                      args=(device,), timeout_s=MESH_TIMEOUT_S)
    rows = outs[0].result
    if any(out.result != rows for out in outs):
        raise RuntimeError("mesh ranks diverged in the partial sweep")
    return rows


def _run_feedback(enabled: bool, seed: int, lad: dict) -> dict:
    """Static-q SLO fallback vs observed-violation feedback (heavy tails).

    Realized step latency = masked completion + the served rung's priced
    overhead - exactly what the feedback window judges against the SLO.
    """
    feed = make_scenario("heavy_tail").compile(K, seed=seed)
    ladder = PlanLadder(P, M, N, K=K, L=L_SMALL, **lad)
    ladder.prewarm((V, R), (V, T))
    policy = ExpectedLatencyPolicy(ladder, overhead_s=Q_OVERHEAD)
    server = AdaptiveServer(
        ladder, policy=policy, feed=feed, seed=seed,
        slo_quantile=FB_Q_BASE, slo_s=FB_SLO_S,
        feedback=FeedbackConfig(**FB_CONFIG) if enabled else None)
    zeros = lambda *shape: torch.zeros(  # noqa: E731
        shape, dtype=torch.float64, device=ladder.device)
    A, B = zeros(V, R), zeros(V, T)
    reports = server.run(FB_STEPS, lambda i: (A, B))[FB_WARMUP:]
    realized = np.array([r.sim_latency_s + Q_OVERHEAD[r.rung]
                         for r in reports])
    return {
        "policy": "feedback" if enabled else "static_q",
        "seed": seed,
        "violations": int((realized > FB_SLO_S).sum()),
        "steps": len(reports),
        "p50_s": float(np.quantile(realized, 0.5)),
        "p99_s": float(np.quantile(realized, 0.99)),
        "rungs": _rung_counts(reports),
    }


def _run_feedback_sweep(lad: dict) -> list:
    """static-q vs feedback over identical heavy-tailed feeds per seed."""
    return [_run_feedback(enabled, seed, lad)
            for seed in FB_SEEDS for enabled in (False, True)]


def _run_elastic(seed: int, lad: dict) -> dict:
    """Elastic shrink-then-grow through the adaptive server (EXECUTED).

    A polycode-only ladder (budget 2) on a worker universe of 12 serves on
    an initial pool of 10; three departures exceed slack and trigger the
    executed shrink handoff (only bec fits the shrunk pool), then the two
    absent workers join at ``EL_JOIN`` on incrementally extended points and
    the policy re-ranks back to polycode.  Serving after the grow's own
    prewarm must build nothing, and the old pool's pipelines must survive.
    """
    scenario = make_scenario("pool_resize", num_departing=3,
                             depart_step=EL_DEPART, num_arriving=2,
                             join_step=EL_JOIN)
    feed = scenario.compile(EL_UNIVERSE, seed=seed)
    arriving = scenario.arriving_ids(EL_UNIVERSE, seed)
    absent = {int(i) for i in arriving}
    pool = [i for i in range(EL_UNIVERSE) if i not in absent]

    watch = CompileWatch()
    p, m, n = EL_GRID
    ladder = PlanLadder(p, m, n, K=len(pool), L=L_SMALL, include=["polycode"],
                        **lad)
    ladder.prewarm((V, R), (V, T))
    policy = ExpectedLatencyPolicy(ladder, overhead_s=EL_OVERHEAD)
    server = AdaptiveServer(ladder, policy=policy, feed=feed, seed=seed,
                            check_exact=True,
                            universe=EL_UNIVERSE, pool=pool)
    A, B = _operands(seed + 1, ladder.device)

    shrink_step = None
    exec_keys_pre_grow: set = set()
    for i in range(EL_STEPS):
        if i == EL_JOIN:
            exec_keys_pre_grow = set(ladder.group.executables)
            server.grow(arriving)
            watch.mark()  # grow's own prewarm built the grown pool;
            # everything SERVED after it must hit the memo.
        server.step(A, B)
        if shrink_step is None and len(server.pool) < len(pool):
            shrink_step = i
    reports = server.reports
    priced = np.array([r.sim_latency_s + EL_OVERHEAD[r.rung]
                       for r in reports])
    return {
        "seed": seed,
        "universe": EL_UNIVERSE,
        "pool_initial": len(pool),
        "pool_shrunk": (len(reports[shrink_step].pool)
                        if shrink_step is not None else None),
        "pool_final": len(reports[-1].pool),
        "shrink_step": shrink_step,
        "join_step": EL_JOIN,
        "respecializations": int(sum(r.respecialize for r in reports)),
        "rung_first": reports[0].rung,
        "rung_shrunk": (reports[shrink_step].rung
                        if shrink_step is not None else None),
        "rung_final": reports[-1].rung,
        "pre_depart_mean_s": float(priced[:EL_DEPART].mean()),
        "shrunk_mean_s": (float(priced[shrink_step:EL_JOIN].mean())
                          if shrink_step is not None else None),
        "post_grow_mean_s": float(priced[EL_JOIN:].mean()),
        "post_grow_recompiles": watch.delta(),
        "old_executables_survived": exec_keys_pre_grow
        <= set(ladder.group.executables),
        "all_exact": all(r.exact for r in reports),
    }


def _run_exhausted(seed: int, lad: dict) -> dict:
    """Budget-exhaustion handoff: a polycode-only ladder (budget 1) facing 3
    persistent stragglers must flag a respecialisation (plan_shrink)."""
    S = 3
    traces = _traces(S, seed)
    ladder = PlanLadder(P, M, N, K=K, L=L_SMALL, include=["polycode"], **lad)
    ladder.prewarm((V, R), (V, T))
    server = AdaptiveServer(ladder, feed=lambda step, rng: traces[step],
                            seed=seed, check_exact=True)
    A, B = _operands(seed + 1, ladder.device)
    reports = server.run(STEPS, lambda i: (A, B))
    events = [rep for rep in reports if rep.respecialize]
    return {
        "ladder": list(ladder.rungs),
        "stragglers": S,
        "budget": ladder.budget("polycode"),
        "respecializations": len(events),
        "shrink_target": list(events[0].shrink_target) if events else None,
        "all_exact": all(rep.exact for rep in reports),
    }


def run(sweep: str = "all", backend: str = "reference", device=None) -> dict:
    """Run ``sweep`` ("all", "partial_sweep" or "elastic_sweep") on the
    ladder ``backend`` and ``device``; returns the rows with their config
    (on "mesh", under the ``partial_sweep_mesh`` key).

    Raises:
        ValueError: for "mesh" with another sweep than partial_sweep.
    """
    if backend == "mesh" and sweep != "partial_sweep":
        raise ValueError("--backend mesh only applies to the partial_sweep sweep")
    partial_config = {
        "scenarios": list(PARTIAL_SCENARIOS), "sub_tasks": PARTIAL_SUB_TASKS,
        "steps": PARTIAL_STEPS, "warmup": PARTIAL_WARMUP,
        "seed": PARTIAL_SEED, "overhead_s": Q_OVERHEAD, "backend": backend,
    }
    elastic_config = {
        "grid": list(EL_GRID), "universe": EL_UNIVERSE, "steps": EL_STEPS,
        "depart_step": EL_DEPART, "join_step": EL_JOIN, "seed": EL_SEED,
        "overhead_s": EL_OVERHEAD, "include": ["polycode"],
    }
    if backend == "mesh":
        cfg = dict(partial_config, scenarios=list(PARTIAL_MESH_SCENARIOS))
        return {"config": {"partial_sweep_mesh": cfg},
                "partial_sweep_mesh": _run_mesh_partial_sweep(device)}
    lad = ladder_kw(backend, device)
    if sweep == "partial_sweep":
        return {"config": {"partial_sweep": partial_config},
                "partial_sweep": _run_partial_sweep(lad)}
    if sweep == "elastic_sweep":
        return {"config": {"elastic_sweep": elastic_config},
                "elastic_sweep": _run_elastic(EL_SEED, lad)}
    return {
        "config": {
            "grid": [P, M, N], "K": K, "shape": [V, R, T], "steps": STEPS,
            "resample_every": RESAMPLE_EVERY, "base_s": BASE_S,
            "slowdown": SLOWDOWN, "jitter": JITTER,
            "L": {"small": L_SMALL, "large": L_LARGE},
            "backend": backend,
            "quantile_sweep": {
                "steps": Q_STEPS, "warmup": Q_WARMUP, "slo_quantile": Q_SLO,
                "heavy_jitter": HEAVY_JITTER, "healthy_jitter": HEALTHY_JITTER,
                "overhead_s": Q_OVERHEAD, "batches": list(Q_BATCHES),
                "buckets": list(Q_BUCKETS),
            },
            "scenario_sweep": {"steps": SC_STEPS, "seed": SC_SEED},
            "feedback_sweep": {
                "steps": FB_STEPS, "warmup": FB_WARMUP,
                "q_base": FB_Q_BASE, "slo_s": FB_SLO_S,
                "seeds": list(FB_SEEDS), "scenario": "heavy_tail",
                "overhead_s": Q_OVERHEAD, "config": FB_CONFIG,
            },
            "partial_sweep": partial_config,
            "elastic_sweep": elastic_config,
        },
        "regimes": [_run_regime(L, S, seed=17 + S, lad=lad)
                    for L in (L_SMALL, L_LARGE) for S in STRAGGLER_COUNTS],
        "quantile_sweep": _run_quantile_sweep(lad),
        "scenario_sweep": _run_scenario_sweep(lad),
        "feedback_sweep": _run_feedback_sweep(lad),
        "partial_sweep": _run_partial_sweep(lad),
        "elastic_sweep": _run_elastic(EL_SEED, lad),
        "exhausted": _run_exhausted(29, lad),
    }


def check_elastic(row: dict) -> None:
    """Acceptance gates of the elastic sweep (the reference's, unchanged).

    The run must SURVIVE a shrink that exceeds the active rung's slack,
    RECOVER throughput after the grow, and the grow must build NOTHING for
    pre-existing rungs.
    """
    assert row["all_exact"], f"inexact decode in the elastic sweep: {row}"
    assert row["shrink_step"] is not None, (
        f"the shrink handoff never executed: {row}")
    assert row["respecializations"] > 0, (
        f"no respecialisation event recorded: {row}")
    assert row["pool_shrunk"] < row["pool_initial"], (
        f"pool did not shrink: {row}")
    assert row["rung_shrunk"] != row["rung_first"], (
        f"shrink did not re-lower the rung: {row}")
    assert row["pool_final"] > row["pool_shrunk"], (
        f"pool did not grow back: {row}")
    assert row["rung_final"] == row["rung_first"], (
        f"grow did not recover the wide rung: {row}")
    assert row["post_grow_mean_s"] < 0.8 * row["shrunk_mean_s"], (
        f"no throughput recovery after grow: {row}")
    assert row["post_grow_mean_s"] <= 1.25 * row["pre_depart_mean_s"], (
        f"post-grow price did not return to the pre-departure level: {row}")
    assert_no_recompiles(row["post_grow_recompiles"],
                         "serving after the elastic grow")
    assert row["old_executables_survived"], (
        f"grow evicted pre-existing executables: {row}")


def check_partial(rows: list) -> None:
    """Acceptance gates of the partial sweep (the reference's, unchanged):
    partial never loses to binary on realized p99, strictly beats it under
    heavy_tail and pareto, consumes fractions, stays exact and build-free,
    and Q=1 is bit-identical to the mask path."""
    by_name = {row["scenario"]: row for row in rows}
    assert {"heavy_tail", "pareto"} <= set(by_name), (
        f"partial sweep missing its win regimes: {sorted(by_name)}")
    for row in rows:
        binary, partial = row["binary"], row["partial"]
        for side in (binary, partial):
            assert side["all_exact"], f"inexact partial-sweep decode: {row}"
            assert_no_recompiles(
                side["recompiles"],
                f"the partial sweep ({row['scenario']}, "
                f"Q={side['sub_tasks']})")
        assert row["q1_bit_identical"], (
            f"Q=1 partial decode diverged from the legacy mask path: {row}")
        assert partial["p99_s"] <= binary["p99_s"] * 1.001, (
            f"partial LOST to binary erasure on p99 at "
            f"{row['scenario']}: {row}")
        assert partial["fractional_consumptions"] > 0, (
            f"partial server never consumed a fraction at "
            f"{row['scenario']}: {row}")
    for name in ("heavy_tail", "pareto"):
        row = by_name[name]
        assert row["partial"]["p99_s"] < 0.95 * row["binary"]["p99_s"], (
            f"partial did not STRICTLY beat binary p99 under {name}: {row}")


def check_mesh(rows: list) -> None:
    """The partial sweep's gates on the mesh rows, which must also equal
    the reference's ``partial_sweep_mesh`` rows in ``BENCH_control.json``."""
    check_partial(rows)
    want = json.loads(BENCH_FILE.read_text())["partial_sweep_mesh"]
    assert rows == want, (
        f"mesh partial-sweep rows differ from {BENCH_FILE.name}: {rows} vs {want}")


def check_feedback(rows: list) -> None:
    """Feedback never adds realized violations or worsens p99 at a seed,
    and strictly removes violations at one seed at least."""
    by_seed: dict = {}
    for row in rows:
        by_seed.setdefault(row["seed"], {})[row["policy"]] = row
    reduced = 0
    for seed, pair in by_seed.items():
        static, fb = pair["static_q"], pair["feedback"]
        assert fb["violations"] <= static["violations"], (
            f"feedback INCREASED realized violations at seed {seed}: {pair}")
        assert fb["p99_s"] <= static["p99_s"] * 1.02, (
            f"feedback worsened realized p99 at seed {seed}: {pair}")
        reduced += fb["violations"] < static["violations"]
    assert reduced > 0, (
        "feedback never strictly reduced realized SLO violations vs the "
        f"static-q policy: {rows}")


def check(result: dict) -> None:
    """Every acceptance gate of the full bench (the reference's ``check``)."""
    for row in result["regimes"]:
        assert row["all_exact"], f"inexact decode: {row}"
        assert_no_recompiles(
            row["recompiles"],
            f"regime L={row['L']} S={row['stragglers']}")
        feasible = [r for r, ok in row["static_feasible"].items() if ok]
        assert set(row["adaptive_rungs"]) <= set(feasible), (
            f"adaptive served an invalid rung: {row}")
        best_static = min(row["static_s"][r] for r in feasible)
        if row["stragglers"] == 0:
            assert row["adaptive_s"] <= best_static * 1.05, (
                f"adaptive worse than best static at S=0: {row}")
    beats = [row for row in result["regimes"]
             if row["stragglers"] > 0
             and row["adaptive_s"] < min(row["static_s"].values()) * 0.95]
    assert beats, "adaptive never beat every static rung in a straggler regime"
    large = [row for row in result["regimes"] if row["L"] == L_LARGE]
    assert all("bec" not in row["adaptive_rungs"] for row in large), (
        "policy served bec past its entry-bound feasibility")
    by_s: dict = {}
    for row in result["quantile_sweep"]:
        assert row["all_exact"], f"inexact batched decode: {row}"
        assert_no_recompiles(
            row["recompiles"],
            f"batched rung switches (policy {row['policy']}, "
            f"S={row['stragglers']})")
        by_s.setdefault(row["stragglers"], {})[row["policy"]] = row
    for S, pair in by_s.items():
        mean, quant = pair["mean"], pair["quantile"]
        if S == 0:
            assert abs(quant["p99_s"] - mean["p99_s"]) <= 0.05 * mean["p99_s"], (
                f"policies diverge with no stragglers (S=0): {pair}")
        else:
            assert quant["p99_s"] < 0.95 * mean["p99_s"], (
                f"quantile policy did not beat mean policy on p99 at "
                f"S={S}: {pair}")
    ex = result["exhausted"]
    assert ex["respecializations"] > 0 and ex["shrink_target"], (
        f"no respecialisation handoff under exhausted budget: {ex}")
    for row in result["scenario_sweep"]:
        for variant in ("stressed", "calm"):
            v = row[variant]
            assert v["all_exact"], f"inexact decode ({variant}): {row}"
            assert_no_recompiles(
                v["recompiles"], f"{variant} {row['scenario']}")
        # the S=0 criterion, stated so it CAN fail: at the calm control the
        # monitor must erase NOBODY, forcing adaptive_s == static_s exactly.
        calm = row["calm"]
        assert calm["erasures"] == 0, (
            f"monitor erased healthy workers at calm "
            f"{row['scenario']}: {calm}")
        assert calm["respecializations"] == 0, (
            f"spurious respecialisation at calm {row['scenario']}: {calm}")
        assert calm["adaptive_s"] == calm["static_s"], (
            f"adaptive diverged from best static at calm "
            f"{row['scenario']}: {calm}")
        stressed = row["stressed"]
        assert stressed["adaptive_s"] <= stressed["static_s"] * 0.9, (
            f"adaptive failed to beat static under stressed "
            f"{row['scenario']}: {stressed}")
        assert stressed["erasures"] > 0, (
            f"no erasures under stressed {row['scenario']}: {stressed}")
    check_feedback(result["feedback_sweep"])
    check_partial(result["partial_sweep"])
    check_elastic(result["elastic_sweep"])


def rows_text(result: dict) -> list:
    """One printable line per bench row (what ``main`` prints)."""
    lines = []
    for row in result.get("regimes", ()):
        static = {r: round(s, 3) for r, s in row["static_s"].items()}
        lines.append(
            f"L={row['L']:>6} S={row['stragglers']}: static {static} vs "
            f"adaptive {row['adaptive_s']:.3f} s (rungs "
            f"{row['adaptive_rungs']}, switches {row['switches']}, "
            f"recompiles {row['recompiles']})")
    for row in result.get("quantile_sweep", ()):
        lines.append(
            f"S={row['stragglers']} policy={row['policy']:<8} p50 "
            f"{row['p50_s']:6.2f} s  p99 {row['p99_s']:6.2f} s (rungs "
            f"{row['rungs']}, recompiles {row['recompiles']})")
    for row in result.get("scenario_sweep", ()):
        s, c = row["stressed"], row["calm"]
        lines.append(
            f"scenario {row['scenario']:<12} stressed: static "
            f"{s['static_s']:6.2f} vs adaptive {s['adaptive_s']:6.2f} s | "
            f"calm: static {c['static_s']:5.2f} vs adaptive "
            f"{c['adaptive_s']:5.2f} s")
    for row in result.get("feedback_sweep", ()):
        lines.append(
            f"feedback seed={row['seed']} policy={row['policy']:<9} "
            f"violations {row['violations']:2d}/{row['steps']} p50 "
            f"{row['p50_s']:5.2f} s  p99 {row['p99_s']:5.2f} s (rungs "
            f"{row['rungs']})")
    for row in (*result.get("partial_sweep", ()),
                *result.get("partial_sweep_mesh", ())):
        b, p = row["binary"], row["partial"]
        lines.append(
            f"partial [{row['backend']}] {row['scenario']:<12} binary p99 "
            f"{b['p99_s']:6.2f} s vs Q={p['sub_tasks']} p99 {p['p99_s']:6.2f} "
            f"s (p50 {b['p50_s']:5.2f} -> {p['p50_s']:5.2f} s, "
            f"{p['fractional_consumptions']} fractional consumptions, q1 "
            f"parity {row['q1_bit_identical']})")
    if "elastic_sweep" in result:
        row = result["elastic_sweep"]
        lines.append(
            f"elastic: pool {row['pool_initial']} -> {row['pool_shrunk']} "
            f"(shrink step {row['shrink_step']}, {row['rung_first']} -> "
            f"{row['rung_shrunk']}) -> {row['pool_final']} (join step "
            f"{row['join_step']}, back to {row['rung_final']}); priced mean "
            f"{row['pre_depart_mean_s']:.2f} -> {row['shrunk_mean_s']:.2f} -> "
            f"{row['post_grow_mean_s']:.2f} s, {row['post_grow_recompiles']} "
            f"post-grow recompiles, old executables survived: "
            f"{row['old_executables_survived']}")
    if "exhausted" in result:
        ex = result["exhausted"]
        lines.append(f"exhausted-budget handoff: {ex['respecializations']} "
                     f"respecialisations -> shrink {ex['shrink_target']}")
    return lines


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sweep", nargs="?", default="all",
                    choices=["all", "partial_sweep", "elastic_sweep"],
                    help="the full bench (default), or only the "
                         "binary-vs-partial or the elastic sweep")
    ap.add_argument("--backend", default="reference", choices=BACKENDS,
                    help="the ladder's backend: reference (plain PyTorch), "
                         "fused or staged (the CUDA kernels on the card), or "
                         "mesh (partial_sweep only: K ranks, one worker each)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    ap.add_argument("--check", action="store_true",
                    help="assert the acceptance criteria")
    args = ap.parse_args(argv)

    result = run(args.sweep, args.backend, args.device)
    for line in rows_text(result):
        print(line)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2) + "\n")
        print(f"wrote {out}")
    if args.check:
        if args.backend == "mesh":
            check_mesh(result["partial_sweep_mesh"])
        else:
            {"all": check,
             "partial_sweep": lambda r: check_partial(r["partial_sweep"]),
             "elastic_sweep": lambda r: check_elastic(r["elastic_sweep"])
             }[args.sweep](result)
        print(f"control bench check ({args.sweep}, {args.backend}): OK")
    return result


if __name__ == "__main__":
    main()
