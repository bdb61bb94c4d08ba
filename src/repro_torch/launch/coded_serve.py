"""Serving driver for the coded-matmul runtime: a request loop over one
``CodedMatmul`` facade, with erasure patterns changing per request.

The port of the JAX package's serving CLI (``repro.launch.coded_serve``):
the same modes, flags, argument errors and printed lines, over
``repro_torch``.  A resident facade absorbs worker loss as DATA (no
rebuilds, no restarts) while the pipeline memo keeps per-request latency at
the warm-call floor.  Every mode runs on the CUDA card (the hand-written
kernels) unless ``--device cpu`` asks for the plain PyTorch versions on the
CPU; without a card and without ``--device`` it raises.

``--adaptive`` swaps the single fixed plan for the control plane
(``repro_torch.control``): a ``PlanLadder`` over the paper's bec <->
tradeoff <-> polycode family, a ``WorkerHealthMonitor`` fed with
(simulated) per-worker step times, and a latency policy that switches rungs
and emits the erasure mask — rebuild-free after ``prewarm()``.
``--policy quantile`` (or ``--slo-quantile``) ranks rungs by tail
completion instead of the mean; ``--slo-ms`` adds the violation fallback
that forces a switch to the tail-optimal rung whenever the active rung's
predicted quantile blows the bound.  ``--batch`` serves batched requests of
VARYING size through prewarmed leading-dim buckets (round-up padding, zero
rebuilds).  ``--sub-tasks Q`` turns on partial-straggler decoding: each
worker's block splits into Q ordered sub-tasks and the monitor's progress
plan consumes completed chunk prefixes from flagged stragglers instead of
erasing them; ``--monitor-threshold`` sets the flagging score (the base of
the adaptive threshold law when ``--feedback`` is on).

Fault injection rides on ``repro_torch.chaos``: ``--scenario NAME`` feeds
the loop from any registered straggler regime (deterministic under
``--seed``) instead of the built-in resampled-straggler feed;
``--feedback`` turns on the observed-violation controller (requires
``--slo-ms``); ``--record PATH`` captures the run (times, decisions, and
the server config) as a JSONL trace; ``--replay PATH`` re-serves the
recorded times verbatim — decisions reproduce bit-deterministically when
the server flags match the recording, and a config drift prints a warning.

``--elastic`` (with ``--adaptive``) serves on an ELASTIC pool: departures
of the ``pool_resize`` scenario exhaust the polycode-only ladder's slack
and trigger the EXECUTED shrink handoff, and at the scenario's join step
the arrivals are admitted onto incrementally extended Vandermonde points.

``--serve-tier`` lifts the loop into the async multi-tenant tier
(``repro_torch.serve``): per-tenant token-bucket admission and bounded
queues, continuous batching into the prewarmed buckets, per-SLO-class
adaptive servers with earliest-deadline-first dispatch, and a two-stage
pipeline overlapping decode of step t with the workers of step t+1 — all
on a seeded simulated clock.  ``--tenant-spec`` takes the spec as inline
JSON or ``@path/to/spec.json``; ``--requests`` becomes per-tenant;
``--record`` saves a replayable serve trace; ``--no-pipeline`` serialises
the stages for A/B comparison.

``--metrics-out PATH`` / ``--perfetto-out PATH`` enable the observability
layer (``repro_torch.obs``) for the run and write its Prometheus text dump
and Chrome-trace/Perfetto span JSON.  Render a terminal summary with
``python -m repro_torch.obs.report --metrics PATH [--perfetto PATH]``.

``--backend mesh`` serves the static and ``--adaptive`` modes with one
worker per rank (``launch/mesh.py``): the mesh is (1, K), K = 4 (static) or
12 (adaptive).  The CLI starts the K ranks itself, or under ``torchrun``
joins the launcher's group and takes a (WORLD_SIZE / K, K) mesh.  Every rank
runs the same loop on the same seeded draws; only rank 0 prints (spawned
ranks hand their printed lines to the parent).

``--elastic`` and ``--serve-tier`` do not drive the mesh backend: with
``--backend mesh`` they print the reference's reason and serve on the
reference executor, on the chosen device, as the JAX package's CLI does.

One departure from the JAX package's CLI:

* The serve tier's operands.  The reference draws a pool of
  ``len(tenants) * 64`` operands up front, ``192 v r`` integers on the host
  (49 GB at ``--size 8000``).  The port makes request ``rid``'s operand on
  the device when the tier asks for it, in the same range [-4, 4], from a
  ``torch.Generator`` keyed by ``(seed, rid % pool)``; B has a generator
  of its own.  The tier's records hold no products and do not depend on
  the operands, so they (and the tenant table) equal the reference's.

The static, adaptive and elastic modes draw operands and erasures from one
numpy stream, as the reference does, so their printed erasure sets match
the reference CLI's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.coded_serve --backend fused \\
      --requests 12 --size 256 --fail-rate 0.3
  PYTHONPATH=src python -m repro_torch.launch.coded_serve --adaptive \\
      --requests 16 --size 64 --fail-rate 0.25 --batch 8 \\
      --slo-quantile 0.99 --slo-ms 1800
  PYTHONPATH=src python -m repro_torch.launch.coded_serve --serve-tier \\
      --scenario heavy_tail --requests 12 --seed 11 \\
      --record /tmp/serve.jsonl --device cpu
  PYTHONPATH=src python -m repro_torch.launch.coded_serve --backend mesh \\
      --requests 6 --size 64 --device cpu          # 4 CPU ranks over gloo
  PYTHONPATH=src torchrun --nproc-per-node 12 -m \\
      repro_torch.launch.coded_serve --backend mesh --adaptive   # a card a rank
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.api import uncoded_matmul
from repro_torch.core.numerics import resolve_device

__all__ = ["main", "run_static", "run_adaptive", "run_elastic",
           "run_serve_tier", "serve_tier_operands"]

# the worker counts of the static plan and of the adaptive ladder, which
# are the mesh's "model" sizes under --backend mesh
STATIC_K, ADAPTIVE_K = 4, 12
# outer deadline of the ranks a mesh run spawns (None: none; a stalled
# rank still fails the others after the process group's 60 s timeout)
MESH_TIMEOUT_S = None


def _exact(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> bool:
    """C equals the uncoded ``A^T B`` element for element, on C's device
    (exact for integer inputs)."""
    ref = uncoded_matmul(A, B)
    return C.shape == ref.shape and torch.equal(C, ref)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="fused",
                    choices=["reference", "staged", "fused", "mesh"])
    ap.add_argument("--adaptive", action="store_true",
                    help="serve through the control plane (PlanLadder + "
                         "monitor + expected-latency policy)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--size", type=int, default=256,
                    help="contraction dim v (r = t = v/2)")
    ap.add_argument("--batch", type=int, default=0,
                    help="leading batch dim per request (0 = unbatched)")
    ap.add_argument("--fail-rate", type=float, default=0.25,
                    help="per-request probability a worker is erased "
                         "(adaptive: fraction of persistently slow workers)")
    ap.add_argument("--policy", default=None, choices=["mean", "quantile"],
                    help="adaptive rung ranking: mean completion or the "
                         "--slo-quantile tail (default mean)")
    ap.add_argument("--slo-quantile", type=float, default=None,
                    help="tail quantile the SLO is stated at, e.g. 0.99; "
                         "implies --policy quantile unless --policy mean "
                         "is explicit")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="SLO bound on modelled step completion (ms); a "
                         "predicted violation forces a switch to the "
                         "tail-optimal rung")
    ap.add_argument("--scenario", default=None,
                    help="feed the adaptive loop from a registered "
                         "repro_torch.chaos scenario (see "
                         "chaos.scenario_names) instead of the built-in "
                         "straggler feed")
    ap.add_argument("--feedback", action="store_true",
                    help="observed-violation feedback: tighten/loosen the "
                         "prediction quantile from realized SLO misses "
                         "(adaptive only; requires --slo-ms)")
    ap.add_argument("--sub-tasks", type=int, default=1,
                    help="split each worker's block into Q ordered sub-tasks "
                         "(adaptive only): the decoder consumes completed "
                         "chunk prefixes from flagged stragglers instead of "
                         "erasing them outright (1 = legacy binary masking)")
    ap.add_argument("--monitor-threshold", type=float, default=0.5,
                    help="straggler-score threshold the monitor flags at; "
                         "with --feedback it becomes the BASE of the "
                         "adaptive threshold law")
    ap.add_argument("--elastic", action="store_true",
                    help="adaptive only: serve on an elastic pool driven "
                         "by the pool_resize scenario — departures trigger "
                         "the executed shrink handoff, arrivals join on "
                         "extended evaluation points")
    ap.add_argument("--serve-tier", action="store_true",
                    help="serve through the async multi-tenant tier "
                         "(admission control + continuous batching + "
                         "per-class SLOs + pipelined stages); --requests "
                         "becomes per-tenant")
    ap.add_argument("--tenant-spec", default=None, metavar="SPEC",
                    help="tenant/class spec for --serve-tier: inline JSON "
                         "or @path/to/spec.json (default: the built-in "
                         "three-tenant example)")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="serve-tier batch ceiling (0 = the largest "
                         "prewarmed bucket)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serve-tier: serialise worker and decode stages "
                         "instead of overlapping them (A/B baseline)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable observability and write the run's metrics "
                         "as Prometheus text to PATH (see repro_torch.obs)")
    ap.add_argument("--perfetto-out", default=None, metavar="PATH",
                    help="enable observability and write the run's spans "
                         "as Chrome-trace/Perfetto JSON to PATH (serve "
                         "tier: one track per SLO class)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="record the adaptive run as a JSONL trace")
    ap.add_argument("--replay", default=None, metavar="PATH",
                    help="replay a recorded JSONL trace as the time feed "
                         "(bit-deterministic against the recording)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.feedback and args.slo_ms is None:
        ap.error("--feedback requires --slo-ms (the bound realized "
                 "latencies are judged by)")
    if args.scenario and args.replay:
        ap.error("--scenario and --replay are mutually exclusive feeds")
    if args.sub_tasks < 1:
        ap.error(f"--sub-tasks must be >= 1, got {args.sub_tasks}")
    if not 0.0 < args.monitor_threshold <= 1.0:
        ap.error(f"--monitor-threshold must be in (0, 1], got "
                 f"{args.monitor_threshold}")
    if args.serve_tier:
        if args.adaptive:
            ap.error("--serve-tier already runs the control plane; drop "
                     "--adaptive")
        if args.replay or args.feedback or args.slo_ms is not None:
            ap.error("--serve-tier takes SLOs and feedback from the tenant "
                     "spec, not --slo-ms/--feedback, and does not replay "
                     "adaptive traces")
        runner = run_serve_tier
    elif args.tenant_spec or args.no_pipeline or args.max_batch:
        ap.error("--tenant-spec/--no-pipeline/--max-batch need --serve-tier")
    elif args.elastic:
        if not args.adaptive:
            ap.error("--elastic needs --adaptive (the handoff is driven by "
                     "the control plane)")
        if args.replay or args.feedback or args.slo_ms is not None \
                or args.sub_tasks != 1:
            ap.error("--elastic does not combine with --replay/--feedback/"
                     "--slo-ms/--sub-tasks")
        if args.scenario not in (None, "pool_resize"):
            ap.error("--elastic is driven by the pool_resize scenario; drop "
                     f"--scenario {args.scenario}")
        runner = run_elastic
    elif args.adaptive:
        runner = run_adaptive
    else:
        if args.scenario or args.feedback or args.record or args.replay:
            ap.error("--scenario/--feedback/--record/--replay need "
                     "--adaptive")
        if args.sub_tasks != 1:
            ap.error("--sub-tasks needs --adaptive (partial-straggler "
                     "decoding is driven by the monitor's progress plans)")
        runner = run_static
    if args.backend == "mesh" and runner in (run_static, run_adaptive):
        return _serve_on_mesh(runner, args)
    return _with_obs(runner, args)


def _serve_on_mesh(runner, args):
    """``runner`` on a (data, K) mesh: spawned here as (1, K), or joined
    under torchrun.  Returns rank 0's result."""
    from repro_torch.launch import mesh as mesh_mod

    K = STATIC_K if runner is run_static else ADAPTIVE_K
    device = resolve_device(args.device)
    if mesh_mod.in_torchrun():
        mesh = mesh_mod.join_mesh(model=K, device=device)
        return _mesh_rank(mesh, runner, args, capture=False)[0]
    outs = mesh_mod.spawn_mesh(_mesh_rank, data=1, model=K, device=device,
                               args=(runner, args, True),
                               timeout_s=MESH_TIMEOUT_S)
    result, text = outs[0].result
    print(text, end="")
    return result


def _mesh_rank(mesh, runner, args, capture: bool) -> tuple:
    """One rank's run: ``(result, printed text)``.  Rank 0 prints (into
    the returned text when ``capture``) and writes the exports; the other
    ranks' lines are dropped."""
    import contextlib
    import copy
    import io

    import torch.distributed as dist

    buf = io.StringIO()
    rank = dist.get_rank()
    if rank:
        args = copy.copy(args)
        args.metrics_out = args.perfetto_out = args.record = None
    sink = (contextlib.redirect_stdout(buf) if rank or capture
            else contextlib.nullcontext())
    with sink:
        result = _with_obs(lambda a: runner(a, mesh=mesh), args)
    return result, "" if rank else buf.getvalue()


def _with_obs(runner, args):
    """Run ``runner`` with observability on when an export flag asks.

    ``--metrics-out``/``--perfetto-out`` enable a FRESH obs session (so
    the dumps cover exactly this run), then write the Prometheus text
    and/or Chrome-trace JSON after the runner returns.  Without either
    flag the runner executes with observability untouched (off unless
    REPRO_OBS enabled it), keeping the default path zero-overhead.
    """
    if not (args.metrics_out or args.perfetto_out):
        return runner(args)
    from repro_torch import obs
    from repro_torch.obs.export import write_perfetto, write_prometheus

    obs.enable(fresh=True)
    result = runner(args)
    if args.metrics_out:
        write_prometheus(args.metrics_out, obs.session().registry)
        print(f"metrics -> {args.metrics_out}")
    if args.perfetto_out:
        write_perfetto(args.perfetto_out, obs.session().recorder.spans)
        print(f"perfetto trace -> {args.perfetto_out}")
    return result


def run_static(args, mesh=None):
    from repro_torch.core import make_plan
    from repro_torch.runtime import CodedMatmul

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    v, r, t = args.size, args.size // 2, args.size // 2
    plan = make_plan("bec", 2, 2, 1, K=STATIC_K, L=v * 4 * 4 + 1,
                     points="chebyshev")
    cm = CodedMatmul(plan, args.backend, dtype=torch.float64, device=dev,
                     mesh=mesh)

    def ints(shape):
        return torch.as_tensor(rng.integers(-4, 5, size=shape),
                               dtype=torch.float64, device=dev)

    def request():
        shape = (args.batch,) if args.batch else ()
        A = ints(shape + (v, r))
        B = ints((v, t))
        # any worker can fail; keep at most K - tau failures decodable
        candidates = rng.permutation(plan.K)[: plan.K - plan.tau]
        erased = sorted(int(k) for k in candidates
                        if rng.random() < args.fail_rate)
        return A, B, erased

    print(f"backend={args.backend} K={plan.K} tau={plan.tau} "
          f"v={v} r={r} t={t} batch={args.batch or 'none'}")
    lat = []
    for i in range(args.requests):
        A, B, erased = request()
        t0 = time.perf_counter()
        C = cm(A, B, erased=erased)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        lat.append(ms)
        exact = _exact(C, A, B)
        print(f"req {i:02d}: erased={str(erased) if erased else '[]':<8} "
              f"{ms:8.1f} ms  {'exact' if exact else 'CHECK FAILED'}")
    info = cm.cache_info()
    print(f"cold {lat[0]:.1f} ms -> warm p50 {np.median(lat[1:]):.1f} ms; "
          f"{info['builds']} executable(s), {info['hits']} cache hits, "
          f"{info['panel_builds']} decode panels, "
          f"{cm.executable_cache_size()} jit specialisations")
    return lat


def run_adaptive(args, mesh=None):
    from repro_torch.control import (
        AdaptiveServer,
        ExpectedLatencyPolicy,
        PlanLadder,
    )
    from repro_torch.core import conservative_L
    from repro_torch.core.simulator import LatencyModel

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    p, m, n, K = 4, 2, 1, ADAPTIVE_K
    v = max(args.size - args.size % p, p)
    r, t = (v // 2) - (v // 2) % m, (v // 2) - (v // 2) % n
    backend = args.backend
    ladder = PlanLadder(p, m, n, K=K, L=conservative_L(v, 4, 4),
                        backend=backend, device=dev, mesh=mesh)
    # batched requests vary in size: prewarm power-of-two buckets so
    # round-up padding keeps every size rebuild-free.
    buckets = ()
    if args.batch:
        top = 1 << (args.batch - 1).bit_length()
        buckets = tuple(1 << i for i in range(top.bit_length()))
    info = ladder.prewarm((v, r), (v, t), batch_sizes=buckets,
                          sub_tasks=args.sub_tasks)
    builds_at_prewarm = info["builds"]
    print(f"adaptive ladder rungs={ladder.rungs} "
          f"taus={[ladder.tau(x) for x in ladder.rungs]} K={K} "
          f"v={v} r={r} t={t} buckets={buckets or 'none'} "
          f"sub_tasks={args.sub_tasks}; "
          f"prewarm: {builds_at_prewarm} executables, overheads "
          f"{ {k: round(1e3 * s, 2) for k, s in info['overhead_s'].items()} } ms")

    requests = args.requests
    # resolve the EFFECTIVE policy/SLO knobs up front: the recorded
    # config (and the replay drift check) must compare what the server
    # actually runs with, not raw CLI defaults.
    policy_name = args.policy or (
        "quantile" if args.slo_quantile is not None else "mean")
    slo_quantile = args.slo_quantile
    if slo_quantile is None and (policy_name == "quantile"
                                 or args.slo_ms is not None):
        slo_quantile = 0.99
    slo_s = args.slo_ms / 1e3 if args.slo_ms is not None else None
    server_config = {"policy": policy_name, "slo_quantile": slo_quantile,
                     "slo_ms": args.slo_ms, "feedback": args.feedback,
                     "backend": backend, "size": args.size,
                     "batch": args.batch, "seed": args.seed,
                     "sub_tasks": args.sub_tasks,
                     "monitor_threshold": args.monitor_threshold}
    if args.replay:
        from repro_torch.chaos import Trace

        trace = Trace.load(args.replay)
        if trace.K != K:
            raise SystemExit(f"trace recorded K={trace.K}, ladder has "
                             f"K={K}")
        feed = trace.feed()
        requests = min(requests, len(trace.steps))
        print(f"replaying {args.replay}: {len(trace.steps)} recorded "
              f"steps (meta {trace.meta})")
        # replayed TIMES are always verbatim, but rung decisions only
        # reproduce under the recorded server config — say so instead
        # of letting a silently different config masquerade as replay.
        recorded = trace.meta.get("config")
        if recorded is not None:
            drift = {k: (recorded[k], server_config.get(k))
                     for k in recorded if server_config.get(k) != recorded[k]}
            if drift:
                print("WARNING: server config differs from the recording "
                      f"(decisions will not reproduce): {drift}")
    elif args.scenario:
        from repro_torch.chaos import make_scenario, scenario_names

        if args.scenario not in scenario_names():
            raise SystemExit(f"unknown scenario {args.scenario!r}; "
                             f"have {scenario_names()}")
        feed = make_scenario(args.scenario).compile(K, seed=args.seed)
        print(f"scenario={args.scenario} (seed {args.seed})")
    else:
        # persistent straggler set (resampled every 6 requests): 2x
        # slowdown plus a heavy exponential tail on the slow machines
        n_slow = int(round(args.fail_rate * K))
        state = {"slow": rng.choice(K, size=n_slow, replace=False)}
        base = np.ones(K)
        jitter = np.full(K, 0.02)

        def feed(step, feed_rng):
            if step and step % 6 == 0:
                state["slow"] = feed_rng.choice(K, size=n_slow,
                                                replace=False)
            jit = jitter.copy()
            jit[state["slow"]] = 0.5
            model = LatencyModel(base=base, straggler_slowdown=2.0,
                                 jitter=jit)
            return model.sample(K, state["slow"], feed_rng)

    recorder = None
    if args.record:
        from repro_torch.chaos import TraceRecorder

        recorder = TraceRecorder(
            feed, K, meta={"scenario": args.scenario, "seed": args.seed,
                           "source": "coded_serve",
                           "config": server_config})
        feed = recorder

    def make_request(i):
        shape = ()
        if args.batch:
            shape = (int(rng.integers(1, args.batch + 1)),)
        A = torch.as_tensor(rng.integers(-4, 5, size=shape + (v, r)),
                            dtype=torch.float64, device=dev)
        B = torch.as_tensor(rng.integers(-4, 5, size=(v, t)),
                            dtype=torch.float64, device=dev)
        return A, B

    policy = None
    if policy_name == "mean":
        policy = ExpectedLatencyPolicy(
            ladder, score_threshold=args.monitor_threshold,
            sub_tasks=args.sub_tasks)
    print(f"policy={policy_name}"
          + (f" slo: q{slo_quantile} <= {args.slo_ms} ms"
             if slo_s is not None else "")
          + (" feedback=on" if args.feedback else "")
          + (f" sub_tasks={args.sub_tasks}" if args.sub_tasks > 1 else "")
          + (f" threshold={args.monitor_threshold}"
             if args.monitor_threshold != 0.5 else ""))
    server = AdaptiveServer(ladder, policy=policy, feed=feed,
                            seed=args.seed, check_exact=True,
                            score_threshold=args.monitor_threshold,
                            slo_quantile=slo_quantile, slo_s=slo_s,
                            feedback=args.feedback,
                            sub_tasks=args.sub_tasks)
    for rep in server.run(requests, make_request):
        flag = " SWITCH" if rep.switched else ""
        if rep.slo_violation:
            flag += " SLO-FALLBACK"
        if rep.realized_violation:
            flag += " REALIZED-MISS"
        tail = (f"  q-tail {rep.predicted_tail_s:6.3f} s"
                if rep.predicted_tail_s is not None else "")
        q_eff = (f"  q_eff {rep.q_effective:.3f}"
                 if rep.q_effective is not None else "")
        partial = ""
        if rep.progress is not None:
            # show only the workers consumed at a fraction (< 1 chunk
            # budget); full workers are the quiet common case.
            frac = {k: round(x, 2) for k, x in enumerate(rep.progress)
                    if x < 1.0}
            partial = f"  partial={frac if frac else '{}'}"
        thr_eff = (f"  thr_eff {rep.threshold_effective:.3f}"
                   if rep.threshold_effective is not None else "")
        print(f"req {rep.step:02d}: rung={rep.rung:<15} "
              f"erased={str(list(rep.erased)):<12} "
              f"sim {rep.sim_latency_s:6.3f} s  wall {rep.wall_ms:7.1f} ms"
              f"{tail}{q_eff}{partial}{thr_eff}  slack={rep.slack}  "
              f"{'exact' if rep.exact else 'CHECK FAILED'}{flag}")
    info = ladder.cache_info()
    if info["builds"] != builds_at_prewarm:
        raise RuntimeError(f"recompile after prewarm: {info}")
    print(f"{info['builds']} executables (unchanged since prewarm), "
          f"{info['hits']} cache hits, {info['panel_builds']} decode "
          f"panels, {info['switches']} rung switches")
    if server.feedback is not None:
        fb = server.feedback
        print(f"feedback: {fb.violations}/{fb.observations} realized "
              f"violations, window rate {fb.realized_rate:.3f}, "
              f"q_eff {fb.effective_q():.3f}")
    if recorder is not None:
        out = recorder.finish(server.reports).save(args.record)
        print(f"recorded trace -> {out}")
    return server.reports


def run_elastic(args):
    """Adaptive serving on an elastic pool: executed shrink, then grow.

    Mirrors the golden ``pool_resize_shrink``/``pool_resize_grow`` recipe:
    a polycode-only ladder (narrow erasure budget, so the departures
    exceed slack and force the handoff) on the (3, 2, 1) grid, a worker
    universe of 12 with the scenario's arriving set initially absent, and
    a grow at 3/4 of the run readmitting them on extended points.
    """
    from repro_torch.chaos import make_scenario
    from repro_torch.control import (
        AdaptiveServer,
        ExpectedLatencyPolicy,
        PlanLadder,
    )
    from repro_torch.core import conservative_L

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    universe = 12
    join_step = (3 * args.requests) // 4 if args.requests >= 8 else None
    scenario = make_scenario("pool_resize", num_departing=3,
                             depart_step=4, num_arriving=2,
                             join_step=join_step)
    arriving = scenario.arriving_ids(universe, args.seed)
    absent = {int(i) for i in arriving}
    pool = [i for i in range(universe) if i not in absent]
    feed = scenario.compile(universe, seed=args.seed)

    p, m, n = 3, 2, 1
    v = max(args.size - args.size % p, p)
    r, t = (v // 2) - (v // 2) % m, v // 2
    backend = args.backend
    if backend == "mesh":
        print("--elastic does not drive the mesh backend yet; "
              "falling back to the reference executor")
        backend = "reference"
    ladder = PlanLadder(p, m, n, K=len(pool), L=conservative_L(v, 4, 4),
                        backend=backend, device=dev, include=["polycode"])
    info = ladder.prewarm((v, r), (v, t))
    builds_marker = info["builds"]
    print(f"elastic universe={universe} pool={pool} "
          f"(arriving {sorted(absent)} absent) rungs={ladder.rungs} "
          f"grid=({p},{m},{n}) v={v} r={r} t={t}; "
          f"prewarm: {builds_marker} executables")

    recorder = None
    if args.record:
        from repro_torch.chaos import TraceRecorder

        recorder = TraceRecorder(
            feed, universe,
            meta={"scenario": "pool_resize", "seed": args.seed,
                  "source": "coded_serve", "elastic": True,
                  "universe": universe, "join_step": join_step})
        feed = recorder

    policy = ExpectedLatencyPolicy(
        ladder, score_threshold=args.monitor_threshold)
    server = AdaptiveServer(ladder, policy=policy, feed=feed,
                            seed=args.seed, check_exact=True,
                            score_threshold=args.monitor_threshold,
                            universe=universe, pool=pool)

    def make_request():
        A = torch.as_tensor(rng.integers(-4, 5, size=(v, r)),
                            dtype=torch.float64, device=dev)
        B = torch.as_tensor(rng.integers(-4, 5, size=(v, t)),
                            dtype=torch.float64, device=dev)
        return A, B

    pool_before = tuple(int(x) for x in server.pool)
    for i in range(args.requests):
        if join_step is not None and i == join_step:
            server.grow(arriving)
            builds = ladder.cache_info()["builds"]
            print(f"-- grow at step {i}: admitted {sorted(absent)} on "
                  f"extended points; pool -> "
                  f"{[int(x) for x in server.pool]} "
                  f"({builds - builds_marker} new executables, old pool's"
                  f" reused)")
            builds_marker = builds
            pool_before = tuple(int(x) for x in server.pool)
        A, B = make_request()
        _, rep = server.step(A, B)
        now = tuple(int(x) for x in server.pool)
        if now != pool_before:
            builds = ladder.cache_info()["builds"]
            print(f"-- shrink handoff at step {i}: pool "
                  f"{list(pool_before)} -> {list(now)}; re-lowered onto "
                  f"{rep.rung} ({builds - builds_marker} new "
                  f"executables, survivors' reused)")
            builds_marker = builds
            pool_before = now
        print(f"req {rep.step:02d}: pool={len(now):2d} "
              f"rung={rep.rung:<10} erased={str(list(rep.erased)):<10} "
              f"sim {rep.sim_latency_s:6.3f} s  "
              f"wall {rep.wall_ms:7.1f} ms  slack={rep.slack}  "
              f"{'exact' if rep.exact else 'CHECK FAILED'}"
              f"{' RESPECIALIZED' if rep.respecialize else ''}")
    info = ladder.cache_info()
    if info["builds"] != builds_marker:
        raise RuntimeError(f"recompile outside a pool transition: {info}")
    print(f"{info['builds']} executables ({builds_marker} after the "
          f"last transition — zero steady-state recompiles), "
          f"{info['hits']} cache hits, {info['panel_builds']} decode "
          f"panels, {info['switches']} rung switches")
    if recorder is not None:
        out = recorder.finish(server.reports).save(args.record)
        print(f"recorded trace -> {out}")
    return server.reports


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer tuple ``key``."""
    seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def serve_tier_operands(seed: int, pool: int, shapes, device):
    """The serve tier's operands, made on ``device`` when asked for.

    Returns ``(make_A, B)``: request ``rid``'s (v, r) left operand is drawn
    from a generator keyed ``(seed, 0, rid % pool)`` and the shared (v, t)
    right operand from one keyed ``(seed, 1)``, integers in [-4, 4] as
    float64.  The same request id (modulo the pool) gives the same operand.
    """
    (v, r), (_, t) = shapes
    device = torch.device(device)

    def ints(shape, gen):
        return torch.randint(-4, 5, shape, generator=gen, device=device,
                             dtype=torch.float64)

    def make_A(request):
        return ints((v, r), _generator(device, seed, 0, request.rid % pool))

    return make_A, ints((v, t), _generator(device, seed, 1))


def run_serve_tier(args):
    from repro_torch.control import PlanLadder
    from repro_torch.core import conservative_L
    from repro_torch.serve import (
        DEFAULT_SPEC,
        ServeTier,
        ServeTrace,
        parse_tenant_spec,
    )

    dev = resolve_device(args.device)
    spec = DEFAULT_SPEC
    if args.tenant_spec:
        spec = args.tenant_spec
        if spec.startswith("@"):
            from pathlib import Path

            spec = Path(spec[1:]).read_text()
    classes, tenants = parse_tenant_spec(spec)

    p, m, n, K = 4, 2, 1, 12
    v = max(args.size - args.size % p, p)
    r, t = (v // 2) - (v // 2) % m, (v // 2) - (v // 2) % n
    backend = args.backend
    if backend == "mesh":
        print("--serve-tier does not drive the mesh backend (the split "
              "worker/decode stages run fused on mesh); falling back to "
              "the reference executor")
        backend = "reference"
    ladder = PlanLadder(p, m, n, K=K, L=conservative_L(v, 4, 4),
                        backend=backend, device=dev)
    top = args.max_batch or 8
    buckets = tuple(1 << i for i in range((top - 1).bit_length() + 1))
    split = args.sub_tasks == 1
    info = ladder.prewarm((v, r), (v, t), batch_sizes=buckets,
                          sub_tasks=args.sub_tasks, stages=split)
    builds_at_prewarm = info["builds"]

    feed = None
    if args.scenario:
        from repro_torch.chaos import make_scenario, scenario_names

        if args.scenario not in scenario_names():
            raise SystemExit(f"unknown scenario {args.scenario!r}; "
                             f"have {scenario_names()}")
        feed = make_scenario(args.scenario).compile(K, seed=args.seed)

    tier = ServeTier(
        ladder, classes=tuple(classes.values()),
        tenants=tuple(tenants.values()), feed=feed,
        seed=args.seed, score_threshold=args.monitor_threshold,
        sub_tasks=args.sub_tasks, check_exact=True,
        pipelined=not args.no_pipeline)
    print(f"serve tier: rungs={ladder.rungs} K={K} v={v} r={r} t={t} "
          f"buckets={buckets} pipelined={not args.no_pipeline} "
          f"split_stages={tier.split_stages} "
          f"tenants={sorted(tenants)} classes={sorted(classes)}; "
          f"scenario={args.scenario or 'constant'} seed={args.seed}; "
          f"prewarm: {builds_at_prewarm} executables")

    make_A, B = serve_tier_operands(args.seed, len(tenants) * 64,
                                    ((v, r), (v, t)), dev)
    result = tier.run(make_A, B, args.requests)

    stats = result.tenant_stats()
    print(f"{'tenant':<10} {'class':<10} {'gen':>4} {'adm':>4} "
          f"{'shed':>4} {'p50 s':>8} {'p_slo s':>8} {'slo s':>7} "
          f"{'viol':>5}  met")
    for name, st in stats.items():
        print(f"{name:<10} {st['slo_class']:<10} {st['generated']:>4} "
              f"{st['admitted']:>4} {st['shed']:>4} "
              f"{st['p50_s'] if st['p50_s'] is None else round(st['p50_s'], 3)!s:>8} "
              f"{st['p_slo_s'] if st['p_slo_s'] is None else round(st['p_slo_s'], 3)!s:>8} "
              f"{st['slo_s']:>7} {st['violations']:>5}  "
              f"{'yes' if st['slo_met'] else 'NO'}"
              + (f"  shed_reasons={st['shed_reasons']}"
                 if st['shed_reasons'] else ""))
    cache = ladder.cache_info()
    if cache["builds"] != builds_at_prewarm:
        raise RuntimeError(f"recompile after prewarm: {cache}")
    print(f"{len(result.admitted)}/{len(result.requests)} admitted, "
          f"{len(result.shed)} shed, {len(result.batches)} batches, "
          f"sustained {result.throughput_rps():.3f} req/s (simulated); "
          f"{cache['builds']} executables (unchanged since prewarm)")
    if args.record:
        out = ServeTrace.from_result(result).save(args.record)
        print(f"recorded serve trace -> {out}")
    return result


if __name__ == "__main__":
    main()
