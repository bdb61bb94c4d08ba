#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout (needs one NVIDIA Hopper card, nvcc):

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure:

1. device  - the card's name and power limit, CUDA version;
2. build   - nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
             (one process per source, all at once) and prints ``-Xptxas -v``;
3. kernels - each kernel against its plain PyTorch version on the card, at a
             ragged small shape and at the main path's shapes;
4. main    - ``CodedMatmul(plan)`` on the default "fused" backend serves
             requests at the paper's geometry (bec p=m=n=2, K=10,
             equispaced points, v=r=t=8000, float64, entries in {0..15})
             under rotating erasure patterns; every C must equal A^T B
             element for element, every request must launch each kernel
             exactly once, and the pipeline memo must not rebuild;
5. times   - each kernel, its plain version and one PyTorch call computing
             the same function, timed with CUDA events at the main path's
             shapes, beside the least time the card could take.

The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import bounds, make_plan  # noqa: E402
from repro_torch.core.partition import block_decompose  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.runtime import CodedMatmul  # noqa: E402

# Published H100 SXM peaks at 700 W (NVIDIA data sheet).
PEAK_FP64_TENSOR = 67e12     # FLOP/s, FP64 on the tensor cores (DMMA)
PEAK_FP64_VECTOR = 34e12     # FLOP/s, FP64 outside the tensor cores
PEAK_HBM = 3.35e12           # bytes/s

# The paper's geometry (configs/paper_matmul.py) at entry bound 15, which is
# exact in float64 (entry bound 50 is not: see ROADMAP.md).
V = R = T = 8000
ENTRY_MAX = 15
# Survivor sets bunched at one end of [-1, 1] amplify rounding in the decode
# (erasing workers 0-5 multiplies it by 243 and is inexact even here); these
# patterns amplify it by at most 15.2.
ERASURES = ([0, 2, 4, 6, 8, 9], [1, 3, 5, 7, 9], [], [2, 3, 4, 5, 6, 7])
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cm_mask(plan, erased) -> np.ndarray:
    mask = np.ones(plan.K)
    mask[erased] = 0
    return mask


def rel_err(out: torch.Tensor, exp: torch.Tensor) -> tuple:
    err = float((out - exp).abs().max())
    return err, err / (float(exp.abs().max()) + 1e-30)


def device_phase() -> dict:
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  device {name}  "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi.splitlines()[0]}


def build_phase() -> None:
    phase("2 build")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def fused_inputs(plan, A, B, dtype):
    g = plan.scheme.grid
    ca = torch.as_tensor(plan.coeff_a.reshape(plan.K, -1), dtype=dtype, device="cuda")
    cb = torch.as_tensor(plan.coeff_b.reshape(plan.K, -1), dtype=dtype, device="cuda")
    return (ca, cb, block_decompose(A.to(dtype), g.p, g.m),
            block_decompose(B.to(dtype), g.p, g.n))


def kernels_phase(plan, A, B, gen) -> dict:
    """Each kernel against its plain version; returns the main-shape errors."""
    phase("3 kernels against their plain versions")
    errs = {}
    for dtype in (torch.float64, torch.float32):
        # ragged small shape: every dimension off the 64-wide tiles
        shapes = dict(ca=(3, 5), cb=(3, 3), a=(5, 129, 257), b=(3, 129, 65))
        x = {k: torch.randn(s, generator=gen, device="cuda", dtype=dtype)
             for k, s in shapes.items()}
        out = ops.fused_worker(x["ca"], x["cb"], x["a"], x["b"])
        err, rel = rel_err(out, ref.fused_worker_ref(x["ca"], x["cb"], x["a"], x["b"]))
        print(f"fused_worker {dtype} ragged {tuple(out.shape)}: max abs err {err:.3e}, "
              f"rel {rel:.3e}")
        check(rel < TOL[dtype], f"fused_worker {dtype} ragged rel err {rel}")
        # main-path shape: the plan's coefficients on strided 4000^2 block views
        args = fused_inputs(plan, A, B, dtype)
        out = ops.fused_worker(*args)
        err, rel = rel_err(out, ref.fused_worker_ref(*args))
        print(f"fused_worker {dtype} main {tuple(out.shape)}: max abs err {err:.3e}, "
              f"rel {rel:.3e}")
        check(rel < TOL[dtype], f"fused_worker {dtype} main rel err {rel}")
        if dtype == torch.float64:
            errs["fused_worker"] = err
            Y = out
        del out, args
    # decode: Y from the integer main-path products, six workers erased
    mask = cm_mask(plan, ERASURES[0])
    W = torch.as_tensor(plan.make_panel_cache().get(mask).W, device="cuda")
    Yf = (Y * torch.as_tensor(mask, device="cuda")[:, None, None]).reshape(plan.K, -1)
    del Y
    for extract in (True, False):
        out = ops.decode(W, Yf, plan.s, extract=extract)
        exp = ref.decode_ref(W, Yf, plan.s, extract)
        err = float((out - exp).abs().max())
        print(f"decode float64 extract={extract} {tuple(W.shape)} x {tuple(Yf.shape)}: "
              f"max abs err {err}")
        check(torch.equal(out, exp), f"decode extract={extract} differs by {err}")
        errs["decode"] = max(err, errs.get("decode", 0.0))
    return errs


def main_phase(plan, A, B) -> dict:
    phase("4 main path")
    L = V * ENTRY_MAX * ENTRY_MAX + 1
    safe = bounds.is_safe(L, plan.s, plan.scheme.digit_depth, "float64", tau=plan.tau)
    print(f"plan bec p=m=n=2 K={plan.K} tau={plan.tau} s=2^{int(np.log2(plan.s))} "
          f"L={L} is_safe(slack 4 bits)={safe}")
    C_ref = A.T @ B  # exact: every partial sum is an integer below 2^53
    cm = CodedMatmul(plan)
    walls = []
    ops.reset_launch_counts()
    for i, erased in enumerate(ERASURES):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = cm(A, B, erased=erased)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after = ops.launch_counts()
        check(C.shape == (R, T) and bool(torch.isfinite(C).all()),
              f"request {i}: C {tuple(C.shape)} not finite (r, t)")
        check(torch.equal(C, C_ref), f"request {i} erased={erased}: max |C - A^T B| "
              f"= {float((C - C_ref).abs().max())}")
        steps = {k: after[k] - before[k] for k in after}
        check(all(d == 1 for d in steps.values()),
              f"request {i} launched {steps}, not one of each kernel")
        info = cm.cache_info()
        check(info["builds"] == 1, f"pipeline memo rebuilt: {info}")
        gain = float(np.abs(cm.panel_cache.get(cm_mask(plan, erased)).W).sum(1).max())
        print(f"request {i} erased={erased}: exact, {walls[-1]:.2f} ms wall, "
              f"launches {steps}, cache {info}, panel gain {gain:.1f}")
    counts = ops.launch_counts()
    check(all(n > 0 for n in counts.values()), f"a kernel never launched: {counts}")
    print(f"main path launches {counts}")
    return {"counts": counts, "walls": walls}


def times_phase(plan, A, B) -> dict:
    phase("5 times")
    ca, cb, a4, b4 = fused_inputs(plan, A, B, torch.float64)
    K, P, Q = plan.K, ca.shape[1], cb.shape[1]
    v, r, t = a4.shape[-2], a4.shape[-1], b4.shape[-1]

    g = plan.scheme.grid
    ca3, cb3 = ca.reshape(K, g.p, g.m), cb.reshape(K, g.p, g.n)

    def library_fused():
        at = torch.einsum("kpm,pmvr->kvr", ca3, a4)
        bt = torch.einsum("kpn,pnvt->kvt", cb3, b4)
        return torch.bmm(at.transpose(1, 2), bt)

    fused = dict(
        ms=time_ms(lambda: ops.fused_worker(ca, cb, a4, b4), 5),
        plain_ms=time_ms(lambda: ref.fused_worker_ref(ca, cb, a4, b4), 5),
        library_ms=time_ms(library_fused, 5))
    flops = 2 * K * r * t * v + 2 * K * (P * v * r + Q * v * t)
    nbytes = 8 * (P * v * r + Q * v * t + K * r * t + K * (P + Q))
    fused["bound_ms"] = max(flops / PEAK_FP64_TENSOR, nbytes / PEAK_HBM) * 1e3
    fused["bound_by"] = "operations"
    print(f"fused_worker: {flops:.4g} FLOP, {nbytes:.4g} B; bound "
          f"{fused['bound_ms']:.3f} ms at FP64 tensor peak "
          f"({flops / PEAK_FP64_VECTOR * 1e3:.3f} ms at FP64 vector peak); "
          f"kernel {fused['ms']:.3f} ms, plain {fused['plain_ms']:.3f} ms, "
          f"einsum+bmm {fused['library_ms']:.3f} ms")

    Y = ops.fused_worker(ca, cb, a4, b4).reshape(K, -1)
    del ca, cb, a4, b4
    W = torch.as_tensor(plan.make_panel_cache().get(np.ones(K)).W, device="cuda")
    mn, E, s = W.shape[0], Y.shape[1], plan.s

    def library_decode():
        C_hat = torch.remainder(torch.round(torch.matmul(W, Y)), s)
        return torch.where(C_hat <= s / 2, C_hat, C_hat - s)

    dec = dict(
        ms=time_ms(lambda: ops.decode(W, Y, s), 20),
        plain_ms=time_ms(lambda: ref.decode_ref(W, Y, s), 20),
        library_ms=time_ms(library_decode, 20))
    flops = 2 * mn * K * E
    nbytes = 8 * (K * E + mn * K + mn * E)
    dec["bound_ms"] = max(flops / PEAK_FP64_TENSOR, nbytes / PEAK_HBM) * 1e3
    dec["bound_by"] = "bytes"
    print(f"decode: {flops:.4g} FLOP, {nbytes:.4g} B; bound {dec['bound_ms']:.3f} ms "
          f"at HBM peak; kernel {dec['ms']:.3f} ms ({nbytes / dec['ms'] / 1e6:.1f} "
          f"GB/s), plain {dec['plain_ms']:.3f} ms, matmul+extract "
          f"{dec['library_ms']:.3f} ms")
    return {"fused_worker": fused, "decode": dec}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    dev = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    A = torch.randint(0, ENTRY_MAX + 1, (V, R), generator=gen, device="cuda",
                      dtype=torch.float64)
    B = torch.randint(0, ENTRY_MAX + 1, (V, T), generator=gen, device="cuda",
                      dtype=torch.float64)
    plan = make_plan("bec", 2, 2, 2, K=10, L=V * ENTRY_MAX * ENTRY_MAX + 1,
                     points="equispaced")
    errs = kernels_phase(plan, A, B, gen)
    main = main_phase(plan, A, B)
    times = times_phase(plan, A, B)
    wall = main["walls"]
    print(f"request wall time (fused, 8000^2, float64): first {wall[0]:.2f} ms, "
          f"median of the rest {float(np.median(wall[1:])):.2f} ms on {dev['smi']}")

    source = {"fused_worker": ("src/repro_torch/kernels/csrc/coded_fused.cu",
                               "src/repro/kernels/coded_fused.py:105"),
              "decode": ("src/repro_torch/kernels/csrc/coded_decode.cu",
                         "src/repro/kernels/coded_decode.py:57")}
    kernels = [dict(name=name, route="cuda", source=source[name][0],
                    replaces=source[name][1], launches=main["counts"][name],
                    max_abs_err=errs[name], **times[name])
               for name in ("fused_worker", "decode")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
