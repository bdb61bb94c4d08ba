"""Paper Sec. IV on the port: threshold tau vs numeric headroom, p' sweep.

The twin of ``benchmarks/tradeoff_sweep.py``.  For p=8, m=n=2 and the
paper-scale L, sweep p' over divisors of p and report (tau, analytic
max|X|, measured max|Y| on random data, f64-safe?).  The worker products Y
come from ``CodedMatmul(plan, "fused").worker_stage`` (kernel 1) on the
card and from the reference backend on the CPU.  ``cols`` is the operands'
column count (the reference bench fixes it at 64).

Run:  python -m benchmarks.torch_tradeoff_sweep [--v 8000 --cols 8000]
      [--device cpu]   (with src/ on PYTHONPATH; default device: the card)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bounds as bounds_mod
from repro_torch.core import make_plan
from repro_torch.core.numerics import resolve_device
from repro_torch.runtime import CodedMatmul

__all__ = ["run", "main"]


def run(p: int = 8, m: int = 2, n: int = 2, v: int = 256, bound: int = 20,
        cols: int = 64, *, device=None):
    """One row per p' dividing p: ``p_prime, tau, digit_depth,
    log2_analytic_maxX, log2_measured_maxY, f64_safe``."""
    dev = resolve_device(device)
    backend = "fused" if dev.type == "cuda" else "reference"
    rng = np.random.default_rng(0)
    L = bounds_mod.conservative_L(v, bound, bound)
    s = bounds_mod.choose_s(L)
    rows = []
    A = torch.as_tensor(rng.integers(-bound, bound + 1, size=(v, cols)),
                        dtype=torch.float64, device=dev)
    B = torch.as_tensor(rng.integers(-bound, bound + 1, size=(v, cols)),
                        dtype=torch.float64, device=dev)
    for pp in [d for d in range(1, p + 1) if p % d == 0]:
        plan = make_plan("tradeoff", p, m, n, K=m * n * pp + pp - 1 + 2, L=L,
                         p_prime=pp, points="chebyshev")
        Y = CodedMatmul(plan, backend, device=dev).worker_stage(A, B)
        max_y = float(Y.abs().max())
        del Y
        analytic = bounds_mod.max_abs_coefficient(
            L, s, plan.scheme.digit_depth)
        rows.append({
            "p_prime": pp, "tau": plan.tau,
            "digit_depth": plan.scheme.digit_depth,
            "log2_analytic_maxX": float(np.log2(analytic)),
            "log2_measured_maxY": float(np.log2(max_y + 1)),
            "f64_safe": bounds_mod.is_safe(
                L, s, plan.scheme.digit_depth, "float64", tau=plan.tau),
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--v", type=int, default=256)
    ap.add_argument("--cols", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rows = run(v=args.v, cols=args.cols, device=args.device)
    print("p_prime,tau,digit_depth,log2_analytic_maxX,log2_measured_maxY,f64_safe")
    for r in rows:
        print(f"{r['p_prime']},{r['tau']},{r['digit_depth']},"
              f"{r['log2_analytic_maxX']:.1f},{r['log2_measured_maxY']:.1f},"
              f"{r['f64_safe']}")
    return rows


if __name__ == "__main__":
    main()
