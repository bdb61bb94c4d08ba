"""Serving-path bench on the port: cold vs warm calls per backend.

The twin of ``benchmarks/runtime_bench.py`` over ``repro_torch.runtime``.
The facade memoises one pipeline per (backend, shape, dtype, erasure kind)
and passes the erasure pattern as data, so a serving loop that sees a NEW
erasure pattern every call still reuses one pipeline.  Per backend:

  cold_ms     first call: pipeline build, decode panel, (on the card) the
              kernels' first launches
  warm_ms     mean over repeated calls, each with a DIFFERENT mask
  executables memoised pipelines after the loop (must stay at 1)
  builds      the ``runtime.executable.compile`` counter's delta over the
              row (``benchmarks/torch_obs_util.py``): must equal 1

The gate is executables == builds == 1 for every row: the proof that the
cache removes rebuilds from serving.  The mesh row runs on a (2, 4) mesh of
ranks that ``launch/mesh.py::spawn_mesh`` starts (gloo on the CPU; on one
card the ranks share it); its numbers are rank 0's.  Times on the CPU are
the plain versions' and say nothing of the card.  Rows go only to
``--out``.

Usage:
  python -m benchmarks.torch_runtime_bench                  # the card
  python -m benchmarks.torch_runtime_bench --device cpu --out rows.json
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from benchmarks.torch_obs_util import CompileWatch
from repro_torch import obs

LOCAL_BACKENDS = ("reference", "staged", "fused")
MESH_TIMEOUT_S = 300


def _problem(device):
    from repro_torch.core import make_plan
    gen = torch.Generator().manual_seed(0)
    v, r, t = 512, 256, 256
    A = torch.randint(-4, 5, (v, r), generator=gen).double().to(device)
    B = torch.randint(-4, 5, (v, t), generator=gen).double().to(device)
    plan = make_plan("bec", 2, 2, 1, K=4, L=v * 4 * 4 + 1, points="chebyshev")
    return plan, A, B


def _masks(K: int, n: int):
    """n distinct single-erasure patterns, cycled."""
    return [[k % K] for k in range(n)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bench_backend(cm, A, B, device, reps: int = 8) -> dict:
    watch = CompileWatch()
    t0 = time.perf_counter()
    cm(A, B, erased=[0])
    _sync(device)
    cold_ms = (time.perf_counter() - t0) * 1e3
    masks = _masks(cm.plan.K, reps)
    for erased in masks:      # warm the panels so warm_ms times the call path
        cm(A, B, erased=erased)
    _sync(device)
    t0 = time.perf_counter()
    for erased in masks:
        cm(A, B, erased=erased)
    _sync(device)
    warm_ms = (time.perf_counter() - t0) * 1e3 / reps
    builds = watch.delta()
    obs.disable()
    return {
        "backend": cm.backend,
        "cold_ms": round(cold_ms, 2),
        "warm_ms": round(warm_ms, 3),
        "cold_over_warm": round(cold_ms / max(warm_ms, 1e-9), 1),
        "warm_patterns": len({tuple(m) for m in masks}),
        "builds": builds,
        "executables": cm.executable_cache_size(),
    }


def run_local(device) -> list:
    from repro_torch.runtime import CodedMatmul
    plan, A, B = _problem(device)
    rows = []
    for backend in LOCAL_BACKENDS:
        # an independent facade per backend: each row's counters start at zero
        row = bench_backend(CodedMatmul(plan, backend, device=device), A, B, device)
        if not row["executables"] == row["builds"] == 1:
            raise AssertionError(f"rebuilds on {backend}: {row}")
        rows.append(row)
    return rows


def _mesh_rank(mesh, device_type: str) -> dict:
    """One rank of the mesh row (module level, so spawned ranks import it)."""
    from repro_torch.core.numerics import resolve_device
    from repro_torch.runtime import CodedMatmul
    device = resolve_device(None, mesh=mesh)
    plan, A, B = _problem(device)
    cm = CodedMatmul(plan, "mesh", mesh=mesh, device=device)
    return bench_backend(cm, A, B, device)


def run_mesh(device) -> list:
    from repro_torch.launch.mesh import spawn_mesh
    outs = spawn_mesh(_mesh_rank, data=2, model=4, device=device,
                      args=(torch.device(device).type,), timeout_s=MESH_TIMEOUT_S)
    row = outs[0].result
    if not row["executables"] == row["builds"] == 1:
        raise AssertionError(f"rebuilds on mesh: {row}")
    return [row]


def run(device) -> list:
    return run_local(device) + run_mesh(device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", help="write the rows here (JSON)")
    args = ap.parse_args(argv)
    from repro_torch.core.numerics import resolve_device
    device = resolve_device(args.device)
    rows = run(device)
    print(f"backend,cold_ms,warm_ms,cold_over_warm,builds,executables  ({device})")
    for r in rows:
        print(f"{r['backend']},{r['cold_ms']},{r['warm_ms']},{r['cold_over_warm']},"
              f"{r['builds']},{r['executables']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
            f.write("\n")
        print(f"saved {args.out}")
    return rows


if __name__ == "__main__":
    main()
