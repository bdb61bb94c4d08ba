"""Straggler simulation (paper Fig. 1 protocol) + on-mesh fault tolerance,
on the PyTorch/CUDA port.

Part 1 - async-cluster model: measured per-worker compute, stragglers
compute twice, completion = tau-th finisher.  BEC (tau=4) stays flat to
S=6; the polynomial-code baseline (tau=9) degrades from S=2
(``benchmarks/torch_fig1_latency.py``).

Part 2 - synchronous-mesh model: the same code on a (2, 4) mesh of ranks
that ``launch/mesh.py`` spawns, one worker per rank, where erasures are a
runtime MASK (lost chips) and the step still returns the exact product on
every rank, from one pipeline for every pattern.

Run:  python examples/torch_straggler_sim.py                (on a CUDA card)
      python examples/torch_straggler_sim.py --device cpu   (gloo CPU ranks)
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks.torch_fig1_latency import run as fig1_run  # noqa: E402
from repro_torch.core import make_plan, uncoded_matmul  # noqa: E402
from repro_torch.launch.mesh import spawn_mesh  # noqa: E402
from repro_torch.runtime import CodedMatmul  # noqa: E402

LOST = ([], [2], [0, 1])


def lost_ranks(mesh) -> tuple:
    """One rank's part of Part 2: its max error per lost set, and the
    facade's cache counters."""
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.integers(0, 9, size=(256, 128)), dtype=torch.float64)
    B = torch.as_tensor(rng.integers(0, 9, size=(256, 128)), dtype=torch.float64)
    plan = make_plan("bec", p=2, m=2, n=1, K=4, L=256 * 8 * 8 + 1, points="chebyshev")
    cm = CodedMatmul(plan, "mesh", mesh=mesh)      # on the rank's device
    C_ref = uncoded_matmul(A, B).to(cm.device)
    errs = [float((cm(A, B, erased=lost) - C_ref).abs().max()) for lost in LOST]
    return errs, cm.cache_info()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()

    print("== Part 1: async-cluster latency (paper Fig. 1, scaled) ==")
    rows = fig1_run(size=512, trials=10, device=args.device)
    by_scheme: dict = {}
    for r in rows:
        by_scheme.setdefault(r["scheme"], []).append(r)
    for scheme, rs in by_scheme.items():
        lat = " ".join(f"S={r['stragglers']}:{r['latency_s']:.3f}s" for r in rs)
        print(f"{scheme} (tau={rs[0]['tau']}): {lat}")

    print("\n== Part 2: synchronous mesh - chip loss absorbed in-step ==")
    outs = spawn_mesh(lost_ranks, data=2, model=4, device=args.device,
                      timeout_s=300)
    errs, info = outs[0].result
    if any(out.result[0] != errs for out in outs):
        raise SystemExit("the mesh ranks decoded different products")
    for lost, err in zip(LOST, errs):
        print(f"lost chips {str(lost or 'none'):<8} -> max error {err} "
              f"({'exact' if err == 0 else 'FAIL'})")
    print(f"(served {info['hits'] + info['builds']} erasure patterns on each of "
          f"{len(outs)} ranks from {info['builds']} pipeline build(s) - the "
          f"pipeline memo absorbs mask churn)")
    if any(errs):
        raise SystemExit("decode must be exact")


if __name__ == "__main__":
    main()
