"""Paper Table I on the port: decoding error vs entry bound L.

The twin of ``benchmarks/table1_error.py``.  The paper (v=8000): bounds
{100,200,500,1000,2000} -> s = 2^28..2^36; error stays <= ~1e-5 through
bound=1000 and the computation is 'useless' at 2000 (|X| ~ (2L)^p/2
overflows float64's 53-bit mantissa).  Both the measured error and the
analytic safe/unsafe verdict (core.bounds) are reported.

Inputs are the reference bench's (``np.random.default_rng(0)``, A and B of
v x v/2 integers in {0..bound}, bec m=n=p=2, K=10 equispaced points, worker
0 erased), moved to the device.  ``fused=True`` serves them through the
fused kernels (kernels 1 and 2 on the card), ``fused=False`` through the
plain reference backend, both via the deprecated ``coded_matmul`` shim as
the reference bench does.

Run:  python -m benchmarks.torch_table1_error [--v 8000] [--fused]
      [--device cpu]   (with src/ on PYTHONPATH; default device: the card)
"""
from __future__ import annotations

import argparse
import warnings

import numpy as np
import torch

from repro_torch.core import bounds as bounds_mod
from repro_torch.core import coded_matmul, make_plan, uncoded_matmul
from repro_torch.core.numerics import resolve_device

__all__ = ["run", "main"]


def run(v: int = 2000,
        bounds_list=(100, 200, 500, 1000, 2000, 5000, 10000, 100000), *,
        fused: bool = False, device=None):
    """One row per entry bound: ``bound, L, s, log2_maxX, rel_err,
    analytic_safe``.  At v=2000 the wrap-around cliff (paper: 'useless' at
    bound 2000 with v=8000) lands ~2 octaves later - bounds 5000/10000
    exhibit it; the mechanism (interpolation error crossing s/2 -> mod-s
    wraps) is identical, shifted by log2(8000/2000) bits of |X| headroom."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    for bound in bounds_list:
        A = torch.as_tensor(rng.integers(0, bound + 1, size=(v, v // 2)),
                            dtype=torch.float64, device=dev)
        B = torch.as_tensor(rng.integers(0, bound + 1, size=(v, v // 2)),
                            dtype=torch.float64, device=dev)
        L = bounds_mod.conservative_L(v, bound, bound)
        s = bounds_mod.choose_s(L)
        plan = make_plan("bec", 2, 2, 2, K=10, L=L, points="equispaced")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            C = coded_matmul(A, B, plan, erased=[0], fused=fused,
                             device=dev)  # one straggler
        C_ref = uncoded_matmul(A, B)
        err = float(torch.linalg.norm(C - C_ref) / torch.linalg.norm(C_ref))
        del A, B, C, C_ref
        safe = bounds_mod.is_safe(L, s, plan.scheme.digit_depth,
                                  "float64", tau=plan.tau,
                                  conditioning_slack_bits=0.0)
        rows.append({"bound": bound, "L": L, "s": s,
                     "log2_maxX": float(np.log2(
                         bounds_mod.max_abs_coefficient(L, s, 1))),
                     "rel_err": err, "analytic_safe": safe})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--v", type=int, default=2000)
    ap.add_argument("--fused", action="store_true",
                    help="serve through the fused kernels (else reference)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rows = run(args.v, fused=args.fused, device=args.device)
    print("bound,s,log2_maxX,rel_err,analytic_safe")
    for r in rows:
        print(f"{r['bound']},2^{int(np.log2(r['s']))},{r['log2_maxX']:.1f},"
              f"{r['rel_err']:.3e},{r['analytic_safe']}")
    return rows


if __name__ == "__main__":
    main()
