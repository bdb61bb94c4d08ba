"""Paper Fig. 1 on the port: completion latency vs straggler count.

The twin of ``benchmarks/fig1_latency.py``.  10 workers, m=n=p=2 block
split, integer matrices with entries in {0..50}.  Per-worker compute time
is MEASURED: one coded block product through ``ops.matmul_t`` (kernel 5 on
the card; ``torch.matmul`` on the same operands is timed beside it, for
reference only).  The master's decode time is the facade's decode stage
(kernel 2 on the card) on precomputed worker products, from the first tau
workers.  Stragglers compute twice (2x slowdown, the paper's model);
completion = tau-th finisher + decode time, from ``simulate_completion``
with the reference bench's seeds and trials.  BEC (tau=4) vs polynomial
code (tau=9); C comes from ``CodedMatmul(plan, "fused")``.

Expected shape (paper Sec. V): BEC flat for S in 0..6, jump at S=7;
polycode degrades from S >= 2.

Run:  python -m benchmarks.torch_fig1_latency [--size 8000] [--device cpu]
      (with src/ on PYTHONPATH; default device: the card; size 0 is the
      reduced SMOKE geometry)
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.paper_matmul import SMOKE as PCFG
from repro_torch.core import (
    LatencyModel,
    make_plan,
    simulate_completion,
    uncoded_matmul,
)
from repro_torch.core.numerics import resolve_device
from repro_torch.kernels import ops
from repro_torch.runtime import CodedMatmul

__all__ = ["run", "main"]


def time_call(fn: Callable[[], object], device: torch.device,
              repeats: int) -> float:
    """Mean seconds of ``fn`` over ``repeats`` calls after one warm-up: CUDA
    events on the current stream on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / repeats


def run(size: int = 0, trials: int = 20, *, device=None,
        t_worker: Optional[float] = None, t_decode: Optional[float] = None):
    """One row per (scheme, S in 0..8): ``scheme, tau, stragglers,
    latency_s, worker_s, decode_s, rel_err``, plus the measured
    ``worker_library_s`` (``torch.matmul``) and ``decode_measured_s``.

    ``t_worker`` / ``t_decode`` (seconds) replace the measured times in the
    simulation, so two simulators can be fed the same times.
    """
    cfg = PCFG if size == 0 else PCFG.__class__(v=size, r=size, t=size)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    A = torch.as_tensor(rng.integers(0, cfg.entry_max + 1, size=(cfg.v, cfg.r)),
                        dtype=torch.float64, device=dev)
    B = torch.as_tensor(rng.integers(0, cfg.entry_max + 1, size=(cfg.v, cfg.t)),
                        dtype=torch.float64, device=dev)
    plans = {
        "bec": make_plan("bec", cfg.p, cfg.m, cfg.n, K=cfg.K, L=cfg.L,
                         points=cfg.points),
        "polycode": make_plan("polycode", cfg.p, cfg.m, cfg.n, K=cfg.K,
                              L=cfg.L, points=cfg.points),
    }

    # ONE worker's compute: a coded block product (the paper's
    # per-machine task) - NOT the serialized all-workers run
    bv, br = cfg.v // cfg.p, cfg.r // cfg.m
    bt = cfg.t // cfg.n
    a_t = torch.as_tensor(rng.normal(size=(bv, br)), device=dev)
    b_t = torch.as_tensor(rng.normal(size=(bv, bt)), device=dev)
    worker_s = time_call(lambda: ops.matmul_t(a_t, b_t), dev, 5)
    library_s = time_call(lambda: torch.matmul(a_t.T, b_t), dev, 5)
    del a_t, b_t
    tw = worker_s if t_worker is None else float(t_worker)

    C_ref = uncoded_matmul(A, B)
    for name, plan in plans.items():
        cm = CodedMatmul(plan, "fused", device=dev)
        # the MASTER's decode, separately, on precomputed Y from the first
        # tau workers (the rest erased)
        Y = cm.worker_stage(A, B)
        late = list(range(plan.tau, plan.K))
        decode_s = time_call(
            lambda: cm.decode_stage(Y, (cfg.r, cfg.t), erased=late), dev, 3)
        del Y
        td = decode_s if t_decode is None else float(t_decode)

        C = cm(A, B)
        err = float(torch.linalg.norm(C - C_ref) / torch.linalg.norm(C_ref))
        del C
        model = LatencyModel(base=tw, straggler_slowdown=cfg.straggler_slowdown)
        for S in range(0, 9):
            lat = simulate_completion(cfg.K, plan.tau, S, model,
                                      decode_time=td, trials=trials, seed=S)
            rows.append({
                "scheme": name, "tau": plan.tau, "stragglers": S,
                "latency_s": float(np.mean(lat)),
                "worker_s": tw, "decode_s": td, "rel_err": err,
                "worker_library_s": library_s, "decode_measured_s": decode_s,
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=0,
                    help="v = r = t (0: the SMOKE geometry, 512)")
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rows = run(args.size, args.trials, device=args.device)
    r0 = rows[0]
    print(f"t_worker {r0['worker_s'] * 1e3:.4f} ms (ops.matmul_t; "
          f"torch.matmul {r0['worker_library_s'] * 1e3:.4f} ms)")
    print("scheme,tau,stragglers,latency_s,decode_s,rel_err")
    for r in rows:
        print(f"{r['scheme']},{r['tau']},{r['stragglers']},"
              f"{r['latency_s']:.4f},{r['decode_s']:.6f},{r['rel_err']:.2e}")
    return rows


if __name__ == "__main__":
    main()
