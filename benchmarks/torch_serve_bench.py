"""Serve-tier bench on the port: pipelined multi-tenant serving vs
back-to-back steps.

The twin of ``benchmarks/serve_bench.py`` over ``repro_torch.serve``: the
same constants, workload, summaries and ``--check`` gates, importing only
the port.  Both sides run the SAME ``ServeTier`` event loop over the same
tenants, the same seeded arrival processes, and the same chaos scenario
feed, on one ``PlanLadder`` shared across every run (so the
zero-rebuild contract is asserted across the WHOLE bench):

* the **tier** runs as designed — continuous batching into prewarmed
  buckets plus the two-stage pipeline (decode of step t overlaps the
  workers of step t+1);
* the **baseline** is synchronous serving: ``max_batch=1`` and
  ``pipelined=False`` reduce the loop to back-to-back ``AdaptiveServer``
  steps.

Per scenario the bench reports sustained req/s (simulated), per-tenant
realized latency quantiles at each tenant's own SLO quantile, and the shed
accounting.  Every admitted request's decoded product is compared bit for
bit against a fresh synchronous facade call on the same operands, on the
ladder's device.  The facade's own ``runtime.executable.compile`` counter
(``CompileWatch``) proves nothing rebuilt after prewarm.

Usage::

    python -m benchmarks.torch_serve_bench --check                   # card, reference
    python -m benchmarks.torch_serve_bench --check --backend fused   # the kernels
    python -m benchmarks.torch_serve_bench --check --device cpu      # plain, on the CPU
    python -m benchmarks.torch_serve_bench --scenario crawler --out rows.json

``--backend`` is the ladder's backend (reference, fused, staged; ``mesh``
is refused: the tier's split worker/decode stages do not run on mesh, and
the reference's bench offers no mesh).  The JSON rows go only to the path
given by ``--out``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from benchmarks.torch_control_bench import BACKENDS, ladder_kw
from benchmarks.torch_obs_util import CompileWatch, assert_no_recompiles
from repro_torch.chaos import make_scenario, scenario_names
from repro_torch.control import PlanLadder
from repro_torch.serve import ServeTier, parse_tenant_spec

MESH_REFUSED = (
    "--serve-tier does not drive the mesh backend (the split worker/decode "
    "stages run fused on mesh); serve the tier on reference, fused or staged")

# ladder geometry shared with control_bench (paper Sec. IV family)
P, M, N, K = 4, 2, 1, 12
V, R, T = 16, 8, 4
BUCKETS = (1, 2, 4, 8)
SEED = 11
REQUESTS = 16               # per tenant per run
#: synthetic per-rung decode cost (simulated seconds): deterministic
#: pricing, and a decode stage thick enough that pipelining has work to
#: overlap.
OVERHEAD_S = {"bec": 2.0, "tradeoff(p'=2)": 1.0, "polycode": 0.1}
CHECK_SCENARIOS = ("heavy_tail", "pareto")

#: the bench workload: a premium tenant with a tight bound and a rung
#: floor, a well-behaved standard tenant, and an overloaded free tier
#: that demonstrably sheds.  The premium tenant ALONE arrives faster
#: than the serial service rate, so even with its EDF priority the
#: baseline queues past the 12 s bound while the batched+pipelined tier
#: stays under it.
SPEC = {
    "classes": [
        {"name": "premium", "quantile": 0.99, "slo_s": 12.0,
         "rung_floor": "tradeoff(p'=2)"},
        {"name": "standard", "quantile": 0.9, "slo_s": 120.0},
    ],
    "tenants": [
        {"name": "gold", "slo_class": "premium", "arrival_rps": 1.5},
        {"name": "silver", "slo_class": "standard", "arrival_rps": 1.0},
        {"name": "free", "slo_class": "standard", "arrival_rps": 2.5,
         "rate_rps": 0.5, "burst": 3, "max_queue": 6},
    ],
}


def _payloads(device):
    """Deterministic integer operands keyed by request id (rng-free)."""
    base = np.arange(V * R).reshape(V, R)

    def make_A(request):
        return torch.as_tensor((base * (request.rid + 3)) % 11 - 5,
                               dtype=torch.float64, device=device)

    B = torch.as_tensor(np.arange(V * T).reshape(V, T) % 7 - 3,
                        dtype=torch.float64, device=device)
    return make_A, B


def _ladder(backend: str = "reference", device=None) -> PlanLadder:
    ladder = PlanLadder(P, M, N, K=K, L=V * 4 * 4 + 1,
                        **ladder_kw(backend, device))
    ladder.prewarm((V, R), (V, T), batch_sizes=BUCKETS, stages=True)
    return ladder


def _run_side(ladder, scenario: str, *, pipelined: bool,
              max_batch) -> "tuple":
    """One ServeTier run (tier or baseline) over a fresh scenario feed."""
    classes, tenants = parse_tenant_spec(SPEC)
    # the ladder is shared across every run of the bench (zero-rebuild
    # contract); reset its switch state so each row is independent of
    # which scenarios ran before it.
    ladder.switch(ladder.rungs[0])
    feed = make_scenario(scenario).compile(K, seed=SEED)
    tier = ServeTier(
        ladder, classes=tuple(classes.values()),
        tenants=tuple(tenants.values()), feed=feed,
        overhead_s=OVERHEAD_S, seed=SEED, check_exact=True,
        pipelined=pipelined, max_batch=max_batch, keep_results=True)
    make_A, B = _payloads(ladder.device)
    result = tier.run(make_A, B, REQUESTS)
    return result, make_A, B


def _bit_identity(ladder, result, make_A, B) -> bool:
    """Every admitted result vs a fresh synchronous facade call, exactly."""
    cm = ladder.facade(ladder.rungs[0])
    return all(torch.equal(cm(make_A(rec), B), result.results[rec.rid])
               for rec in result.completed)


def _summarize(result) -> dict:
    stats = result.tenant_stats()
    shed_reasons: dict = {}
    for rec in result.shed:
        shed_reasons[rec.reject_reason] = \
            shed_reasons.get(rec.reject_reason, 0) + 1
    return {
        "rps": result.throughput_rps(),
        "generated": len(result.requests),
        "admitted": len(result.admitted),
        "completed": len(result.completed),
        "shed": len(result.shed),
        "shed_reasons": shed_reasons,
        "batches": len(result.batches),
        "max_batch_used": max((b.size for b in result.batches), default=0),
        "tenants": stats,
    }


def _run_scenario(ladder, scenario: str) -> dict:
    """Tier vs baseline under one scenario; both sides fully accounted."""
    tier_result, make_A, B = _run_side(ladder, scenario,
                                       pipelined=True, max_batch=None)
    base_result, _, _ = _run_side(ladder, scenario,
                                  pipelined=False, max_batch=1)
    row = {"scenario": scenario, "seed": SEED,
           "tier": _summarize(tier_result),
           "baseline": _summarize(base_result)}
    for side, result in (("tier", tier_result), ("baseline", base_result)):
        summary = row[side]
        summary["accounting_ok"] = (
            summary["generated"] == summary["admitted"] + summary["shed"]
            and all(rec.reject_reason for rec in result.shed)
            and summary["completed"] == summary["admitted"])
        summary["bit_identical"] = _bit_identity(ladder, result, make_A, B)
        summary["all_exact"] = all(
            b.report.get("exact") for b in result.batches)
    return row


def run(scenarios=None, backend: str = "reference", device=None) -> dict:
    """The bench rows for ``scenarios`` (default: the full chaos catalog)
    on a ladder of ``backend`` on ``device`` (default the CUDA card).

    Raises:
        NotImplementedError: for ``backend="mesh"``.
    """
    if backend == "mesh":
        raise NotImplementedError(MESH_REFUSED)
    names = tuple(scenarios) if scenarios else scenario_names()
    # the watch reads the runtime's own build counter; mark() after
    # prewarm makes every later build a recorded rebuild.
    watch = CompileWatch()
    ladder = _ladder(backend, device)
    watch.mark()
    rows = [_run_scenario(ladder, name) for name in names]
    recompiles = watch.delta()
    return {
        "config": {
            "grid": [P, M, N], "K": K, "shape": [V, R, T],
            "buckets": list(BUCKETS), "seed": SEED,
            "requests_per_tenant": REQUESTS, "overhead_s": OVERHEAD_S,
            "spec": SPEC,
        },
        "recompiles": recompiles,
        "scenarios": rows,
    }


def check(result: dict) -> None:
    """The serve-tier acceptance gates (the reference's ``check``).

    Stated so each can FAIL: strict req/s win, premium SLO met by the
    tier AND missed by the baseline (the bound sits between them, so a
    tier regression or a baseline speedup both trip it), explicit shed
    accounting on both sides, per-request bit-identity, zero rebuilds.
    """
    assert_no_recompiles(result["recompiles"], "the serve sweep")
    by_name = {row["scenario"]: row for row in result["scenarios"]}
    missing = set(CHECK_SCENARIOS) - set(by_name)
    assert not missing, f"check scenarios missing from the run: {missing}"
    for name in CHECK_SCENARIOS:
        row = by_name[name]
        tier, base = row["tier"], row["baseline"]
        for side_name, side in (("tier", tier), ("baseline", base)):
            assert side["accounting_ok"], (
                f"{name}/{side_name}: shed requests dropped without a "
                f"reason or counts do not balance: {side}")
            assert side["bit_identical"], (
                f"{name}/{side_name}: a served product diverged from the "
                f"synchronous facade answer")
            assert side["all_exact"], (
                f"{name}/{side_name}: an in-loop exactness check failed")
        assert tier["rps"] > base["rps"], (
            f"{name}: tier did not sustain strictly higher req/s "
            f"({tier['rps']:.3f} vs baseline {base['rps']:.3f})")
        gold_tier = tier["tenants"]["gold"]
        gold_base = base["tenants"]["gold"]
        assert gold_tier["slo_met"], (
            f"{name}: premium tenant missed its SLO under the tier: "
            f"{gold_tier}")
        assert gold_base["p_slo_s"] is not None \
            and gold_base["p_slo_s"] > gold_base["slo_s"], (
                f"{name}: the synchronous baseline MET the premium SLO "
                f"(p{100 * 0.99:.0f} {gold_base['p_slo_s']} <= "
                f"{gold_base['slo_s']} s) — the comparison shows nothing")
        assert tier["shed"] > 0 and tier["shed_reasons"], (
            f"{name}: the overloaded free tier never shed — admission "
            f"control untested: {tier}")


def rows_text(result: dict) -> list:
    """One printable line per scenario row (what ``main`` prints)."""
    lines = []
    for row in result["scenarios"]:
        tier, base = row["tier"], row["baseline"]
        gold_t = tier["tenants"]["gold"]
        gold_b = base["tenants"]["gold"]
        lines.append(
            f"{row['scenario']:<14} tier {tier['rps']:6.3f} req/s "
            f"({tier['batches']} batches, shed {tier['shed']}) vs "
            f"baseline {base['rps']:6.3f} req/s "
            f"({base['batches']} steps, shed {base['shed']}); "
            f"premium tail "
            f"{gold_t['p_slo_s'] and round(gold_t['p_slo_s'], 2)} s "
            f"(met {gold_t['slo_met']}) vs baseline "
            f"{gold_b['p_slo_s'] and round(gold_b['p_slo_s'], 2)} s "
            f"(met {gold_b['slo_met']})")
    return lines


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="run only the heavy-tailed regimes and assert "
                         "the acceptance criteria")
    ap.add_argument("--scenario", action="append", default=None,
                    help="run only these scenarios (repeatable; default: "
                         "the full chaos catalog)")
    ap.add_argument("--backend", default="reference", choices=BACKENDS,
                    help="the ladder's backend: reference (plain PyTorch), "
                         "fused or staged (the CUDA kernels on the card); "
                         "mesh is refused (the tier's split stages do not "
                         "run on mesh)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    args = ap.parse_args(argv)

    scenarios = args.scenario
    if args.check and scenarios is None:
        scenarios = list(CHECK_SCENARIOS)
    result = run(scenarios, args.backend, args.device)
    for line in rows_text(result):
        print(line)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2) + "\n")
        print(f"wrote {out}")
    if args.check:
        check(result)
        print(f"serve bench check ({args.backend}): OK")
    return result


if __name__ == "__main__":
    main()
