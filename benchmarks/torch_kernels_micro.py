"""Microbenchmarks of the port's coded-matmul kernels beside their plain
versions.

The twin of ``benchmarks/kernels_micro.py``: encode, one worker's block
product, the fused encode + product against the staged schedule (through
the runtime's executors, K = 4 workers of a bec 2x2x2 plan), and the
decode, each timed through ``kernels.ops`` (the CUDA kernel on the card,
its plain version on the CPU) and through ``kernels.ref`` (the plain
PyTorch version), with the FLOP or byte count of the call.  Times on the
CPU are PyTorch's CPU kernels and say nothing of the card.

``--check`` is the correctness gate: on the card the fused kernel (one
launch) must match its plain version; on the CPU the plain version must
match the definition written out with ``torch.einsum``.  Both within 1e-4
relative in float32, the reference gate's bound.

Usage:
  python -m benchmarks.torch_kernels_micro                 # the card
  python -m benchmarks.torch_kernels_micro --check --device cpu
  python -m benchmarks.torch_kernels_micro --device cpu --out rows.json
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import make_plan
from repro_torch.core.numerics import resolve_device
from repro_torch.core.partition import block_decompose
from repro_torch.kernels import ops, ref
from repro_torch.runtime import FusedKernelExecutor, ReferenceExecutor, StagedKernelExecutor

CHECK_TOL = 1e-4


def _time(f, *args, device, reps: int = 5) -> float:
    """Microseconds a call, the device synchronised around the loop."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    f(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        f(*args)
    sync()
    return (time.perf_counter() - t0) / reps * 1e6


def _normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def run(device) -> list:
    gen = torch.Generator().manual_seed(0)
    rows = []
    # encode: K = 10 workers, P = 4 blocks of 512 x 512
    K, P, E = 10, 4, 512 * 512
    coeff, blocks = _normal(gen, (K, P), device), _normal(gen, (P, E), device)
    flops = 2 * K * P * E
    rows.append(("encode_kernel", _time(ops.encode, coeff, blocks, device=device),
                 f"flops={flops:.2e}"))
    rows.append(("encode_plain", _time(ref.encode_ref, coeff, blocks, device=device),
                 f"flops={flops:.2e}"))
    # one worker's block product, 512^3
    v = r = t = 512
    A, B = _normal(gen, (v, r), device), _normal(gen, (v, t), device)
    rows.append(("block_matmul_kernel", _time(ops.matmul_t, A, B, device=device),
                 f"flops={2 * v * r * t:.2e}"))
    rows.append(("block_matmul_plain", _time(ref.matmul_t_ref, A, B, device=device),
                 f"flops={2 * v * r * t:.2e}"))
    # the fused encode + product against the staged schedule, K = 4 workers
    # of a bec 2x2x2 plan; fusion saves the coded operands' HBM round trip
    vf = rf = tf = 256
    plan = make_plan("bec", 2, 2, 2, K=4, L=2 * vf * 9 + 1, points="chebyshev")
    ab = block_decompose(_normal(gen, (2 * vf, 2 * rf), device), 2, 2)
    bb = block_decompose(_normal(gen, (2 * vf, 2 * tf), device), 2, 2)
    Kf, Pf = plan.K, 4
    flops_f = Kf * (2 * Pf * vf * rf + 2 * Pf * vf * tf + 2 * vf * rf * tf)
    saved = Kf * 2 * vf * (rf + tf) * 4
    for name, ex in (("fused_worker_kernel", FusedKernelExecutor()),
                     ("staged_encode_matmul_kernel", StagedKernelExecutor()),
                     ("fused_worker_plain", ReferenceExecutor())):
        derived = f"flops={flops_f:.2e}" + (f";hbm_saved_bytes={saved:.2e}"
                                            if name == "fused_worker_kernel" else "")
        rows.append((name, _time(lambda a, b, ex=ex: ex.worker_products(plan, a, b), ab, bb,
                                 device=device), derived))
    # decode: mn = 4 from tau = 4, one E-wide block
    W = _normal(gen, (4, 4), device)
    Y = torch.randint(-100, 100, (4, E), generator=gen).float().to(device)
    rows.append(("decode_kernel", _time(lambda w, y: ops.decode(w, y, 1024.0), W, Y,
                                        device=device), f"bytes={Y.nbytes:.2e}"))
    rows.append(("decode_plain", _time(lambda w, y: ref.decode_ref(w, y, 1024.0), W, Y,
                                       device=device), f"bytes={Y.nbytes:.2e}"))
    return rows


def _einsum_fused(ca, cb, a_blocks, b_blocks) -> torch.Tensor:
    """All K workers' products written out: (sum_p ca[k,p] A_p)^T (sum_q cb[k,q] B_q)."""
    a = torch.einsum("kp,pvr->kvr", ca, a_blocks)
    b = torch.einsum("kq,qvt->kvt", cb, b_blocks)
    return torch.einsum("kvr,kvt->krt", a, b)


def check(device) -> float:
    """The gate: on the card the fused kernel (one launch) against its plain
    version, on the CPU the plain version against the einsum definition."""
    gen = torch.Generator().manual_seed(1)
    ca, cb = _normal(gen, (3, 4), device), _normal(gen, (3, 2), device)
    a_blocks, b_blocks = _normal(gen, (4, 192, 160), device), _normal(gen, (2, 192, 96), device)
    ops.reset_launch_counts()
    out = ops.fused_worker(ca, cb, a_blocks, b_blocks)
    launches = ops.launch_counts()["fused_worker"]
    if device.type == "cuda":
        what, exp = "fused kernel vs plain", ref.fused_worker_ref(ca, cb, a_blocks, b_blocks)
        if launches != 1:
            raise AssertionError(f"the fused kernel launched {launches} times, not once")
    else:
        what, exp = "plain fused worker vs einsum", _einsum_fused(ca, cb, a_blocks, b_blocks)
    err = float((out - exp).abs().max()) / (float(exp.abs().max()) + 1e-9)
    if not err < CHECK_TOL:
        raise AssertionError(f"{what} mismatch: rel err {err:.3e}")
    print(f"fused kernel check OK ({what} on {device}, rel err {err:.3e})")
    return err


def save_json(rows, path: str) -> None:
    records = []
    for name, us, derived in rows:
        rec = {"name": name, "us": round(us, 1)}
        for item in derived.split(";"):
            k, _, val = item.partition("=")
            rec[k] = float(val)
        records.append(rec)
    with open(path, "w") as f:
        json.dump(records, f, indent=2)
        f.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="run the correctness gate only")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", help="write the rows here (JSON)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.check:
        return check(device)
    rows = run(device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if args.out:
        save_json(rows, args.out)
        print(f"saved {args.out}")
    return rows


if __name__ == "__main__":
    main()
