"""Quickstart for the PyTorch/CUDA port: the paper's coded matmul on a card.

Computes C = A^T B with the bounded-entry entangled code (threshold tau=mn,
paper Sec. III-B), kills 6 of 10 workers, and still decodes EXACTLY.  Real
(equispaced) evaluation points, so the product runs through the two CUDA
kernels; unit-circle points would make a complex plan, which runs on the
plain complex PyTorch path instead.

Run:  python examples/torch_quickstart.py            (on a CUDA card)
      python examples/torch_quickstart.py --device cpu   (plain versions)
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import make_plan, uncoded_matmul  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import CodedMatmul  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    device = parser.parse_args().device

    # integer matrices with bounded entries; entry bound 15 keeps the
    # decode exact in float64 (the paper's bound 50 does not at 8000^2)
    rng = np.random.default_rng(0)
    v, r, t = 1024, 512, 512
    A = torch.as_tensor(rng.integers(0, 16, size=(v, r)), dtype=torch.float64)
    B = torch.as_tensor(rng.integers(0, 16, size=(v, t)), dtype=torch.float64)

    # m=n=p=2 block split, K=10 workers -> BEC threshold tau = mn = 4
    L = v * 15 * 15 + 1                     # entry-product bound (Sec. III-D)
    plan = make_plan("bec", p=2, m=2, n=2, K=10, L=L, points="equispaced")
    print(f"scheme=BEC  workers={plan.K}  recovery threshold tau={plan.tau}  "
          f"scale base s=2^{int(np.log2(plan.s))}")

    cm = CodedMatmul(plan, device=device)   # fused CUDA kernels by default
    C = cm(A, B, erased=[0, 2, 4, 6, 8, 9])
    err = float((C.cpu() - uncoded_matmul(A, B)).abs().max())
    print(f"erased 6/10 workers on {cm.device} -> max |C - A^T B| = {err}; "
          f"kernel launches {ops.launch_counts()}")
    if err != 0.0:
        raise SystemExit("decode must be exact")
    print("exact recovery despite 6 erasures - straggler-proof matmul.")


if __name__ == "__main__":
    main()
