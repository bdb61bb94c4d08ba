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
             element for element, every request must launch each of its
             path's kernels as often as the path says, and the pipeline
             memo must not rebuild;
   4b staged  - the same requests on the "staged" backend (encode kernel
             twice, block-matmul kernel once per worker, decode kernel);
   4c partial - ``CodedMatmul(plan, sub_tasks=4)`` under fractional
             progress vectors (fused kernel, per-chunk decode kernel), one
             Q=1 binary request (the binary decode kernel), and one
             worker_stage + decode_stage pair;
5. times   - each kernel, its plain version and one PyTorch call computing
             the same function, timed with CUDA events at the main path's
             shapes, beside the least time the card could take.

Each path's launch counts are set to 0 just before it and read just after.
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
from repro_torch.runtime import CodedMatmul, PartialPattern, chunk_bounds  # noqa: E402

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
# Partial stragglers at Q=4 sub-tasks: completed chunks per worker, each
# vector spanning (>= tau=4 workers per chunk) with every chunk's panel gain
# (max row sum of |W|) at most 10.0, picked with the panel cache on the CPU.
Q_SUB = 4
PROGRESS = ([4, 1, 4, 0, 0, 1, 3, 4, 1, 4], [3, 3, 2, 2, 1, 2, 3, 0, 2, 3],
            [4, 0, 2, 1, 2, 0, 2, 4, 2, 0], [3, 3, 3, 3, 3, 3, 0, 3, 3, 3])
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
KERNELS = ("fused_worker", "decode", "encode", "matmul_t", "decode_partial")


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


def check_close(name: str, out: torch.Tensor, exp: torch.Tensor, dtype) -> float:
    err, rel = rel_err(out, exp)
    print(f"{name} {dtype} {tuple(out.shape)}: max abs err {err:.3e}, rel {rel:.3e}")
    check(out.shape == exp.shape and rel < TOL[dtype], f"{name} {dtype} rel err {rel}")
    return err


def check_exact(name: str, out: torch.Tensor, exp: torch.Tensor) -> float:
    err = float((out - exp).abs().max()) if out.numel() else 0.0
    print(f"{name} {tuple(out.shape)}: max abs err {err}")
    check(torch.equal(out, exp), f"{name} differs by {err}")
    return err


def kernels_phase(plan, A, B, gen) -> dict:
    """Each kernel against its plain version; returns the main-shape errors."""
    phase("3 kernels against their plain versions")
    errs = {}
    K = plan.K
    for dtype in (torch.float64, torch.float32):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

        def ints(*shape):
            return torch.randint(-9, 10, shape, generator=gen, device="cuda").to(dtype)

        # ragged small shapes: every dimension off the 64-wide tiles and the
        # 256-wide thread blocks; random inputs at a relative tolerance (the
        # sums run in another order), integer inputs exactly
        x = dict(ca=rand(3, 5), cb=rand(3, 3), a=rand(5, 129, 257), b=rand(3, 129, 65))
        check_close("fused_worker ragged", ops.fused_worker(x["ca"], x["cb"], x["a"], x["b"]),
                    ref.fused_worker_ref(x["ca"], x["cb"], x["a"], x["b"]), dtype)
        c, blocks = rand(7, 5), rand(5, 37, 1031)
        check_close("encode ragged", ops.encode(c, blocks),
                    ref.encode_ref(c, blocks.reshape(5, -1)).reshape(7, 37, 1031), dtype)
        c, blocks = ints(7, 5), ints(5, 37, 1031)
        check_exact(f"encode {dtype} ragged integer", ops.encode(c, blocks),
                    ref.encode_ref(c, blocks.reshape(5, -1)).reshape(7, 37, 1031))
        a, b = rand(300, 257), rand(300, 65)
        check_close("matmul_t ragged", ops.matmul_t(a, b), ref.matmul_t_ref(a, b), dtype)
        a, b = ints(300, 257), ints(300, 65)
        check_exact(f"matmul_t {dtype} ragged integer", ops.matmul_t(a, b),
                    ref.matmul_t_ref(a, b))
        # main-path shapes: the plan's coefficients on strided 4000^2 block
        # views (fused, encode), one worker's coded blocks (matmul_t)
        args = fused_inputs(plan, A, B, dtype)
        ca, cb, a4, b4 = args
        out = ops.fused_worker(*args)
        err = check_close("fused_worker main", out, ref.fused_worker_ref(*args), dtype)
        if dtype == torch.float64:
            errs["fused_worker"] = err
            Y = out
        del out
        at = ops.encode(ca, a4)
        err = check_close("encode main", at,
                          ref.encode_ref(ca, a4.reshape(ca.shape[1], -1)).reshape(at.shape),
                          dtype)
        errs.setdefault("encode", err)
        bt = ops.encode(cb, b4)
        err = check_close("matmul_t main", ops.matmul_t(at[K - 1], bt[K - 1]),
                          ref.matmul_t_ref(at[K - 1], bt[K - 1]), dtype)
        errs.setdefault("matmul_t", err)
        del args, ca, cb, a4, b4, at, bt
    # decode: Y from the integer main-path products, six workers erased
    mask = cm_mask(plan, ERASURES[0])
    W = torch.as_tensor(plan.make_panel_cache().get(mask).W, device="cuda")
    Yf = (Y * torch.as_tensor(mask, device="cuda")[:, None, None]).reshape(K, -1)
    for extract in (True, False):
        err = check_exact(f"decode float64 extract={extract} {tuple(W.shape)} x",
                          ops.decode(W, Yf, plan.s, extract=extract),
                          ref.decode_ref(W, Yf, plan.s, extract))
        errs["decode"] = max(err, errs.get("decode", 0.0))
    del Yf
    # decode_partial: the same products erased chunk by chunk under a real
    # progress pattern, as the runtime holds them (Y (K, E), chunks of rows)
    pat = PartialPattern.from_progress(K, Q_SUB, np.asarray(PROGRESS[1]) / Q_SUB)
    cmask = torch.as_tensor(pat.chunk_masks, device="cuda")
    rows = chunk_bounds(Y.shape[1], Q_SUB)
    for q in range(Q_SUB):
        Y[:, rows[q]:rows[q + 1], :].mul_(cmask[q][:, None, None])
    cols = [b * Y.shape[2] for b in rows]
    W_stack = torch.as_tensor(plan.make_panel_cache().get_partial(pat.chunk_masks),
                              device="cuda")
    Yf = Y.reshape(K, -1)
    for extract in (True, False):
        err = check_exact(f"decode_partial float64 extract={extract} Q={Q_SUB} "
                          f"{tuple(W_stack.shape)} x",
                          ops.decode_partial(W_stack, Yf, plan.s, extract=extract,
                                             bounds=cols),
                          ref.decode_partial_ref(W_stack, Yf, plan.s, extract, cols))
        errs["decode_partial"] = max(err, errs.get("decode_partial", 0.0))
    return errs


def drive(label: str, requests, C_ref, cm, per_request: dict) -> dict:
    """Serve ``requests`` [(name, call)] through one path, each C exact and
    each request launching exactly ``per_request`` kernels; the counts are
    set to 0 just before the path and read just after it."""
    walls = []
    builds = None
    ops.reset_launch_counts()
    for i, (name, call) in enumerate(requests):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after = ops.launch_counts()
        check(C.shape == (R, T) and bool(torch.isfinite(C).all()),
              f"{label} request {i}: C {tuple(C.shape)} not finite (r, t)")
        check(torch.equal(C, C_ref), f"{label} request {i} {name}: max |C - A^T B| "
              f"= {float((C - C_ref).abs().max())}")
        steps = {k: after[k] - before[k] for k in after}
        want = dict.fromkeys(after, 0) | per_request
        check(steps == want, f"{label} request {i} launched {steps}, not {want}")
        info = cm.cache_info()
        builds = info["builds"] if builds is None else builds
        check(info["builds"] == builds, f"{label}: pipeline memo rebuilt: {info}")
        print(f"{label} request {i} {name}: exact, {walls[-1]:.2f} ms wall, "
              f"launches {({k: v for k, v in steps.items() if v})}, cache {info}")
    counts = ops.launch_counts()
    check(all(counts[k] > 0 for k in per_request), f"{label}: a kernel never launched: "
          f"{counts}")
    print(f"{label} path launches {counts}")
    return {"counts": counts, "walls": walls}


def main_phase(plan, A, B, C_ref) -> dict:
    phase("4 main path")
    L = V * ENTRY_MAX * ENTRY_MAX + 1
    safe = bounds.is_safe(L, plan.s, plan.scheme.digit_depth, "float64", tau=plan.tau)
    print(f"plan bec p=m=n=2 K={plan.K} tau={plan.tau} s=2^{int(np.log2(plan.s))} "
          f"L={L} is_safe(slack 4 bits)={safe}")
    cm = CodedMatmul(plan)
    for erased in ERASURES:
        gain = float(np.abs(cm.panel_cache.get(cm_mask(plan, erased)).W).sum(1).max())
        print(f"erased={erased}: panel gain {gain:.1f}")
    return drive("fused", [(f"erased={e}", lambda e=e: cm(A, B, erased=e)) for e in ERASURES],
                 C_ref, cm, {"fused_worker": 1, "decode": 1})


def staged_phase(plan, A, B, C_ref) -> dict:
    phase("4b staged path")
    cm = CodedMatmul(plan, "staged")
    return drive("staged", [(f"erased={e}", lambda e=e: cm(A, B, erased=e)) for e in ERASURES],
                 C_ref, cm, {"encode": 2, "matmul_t": plan.K, "decode": 1})


def partial_phase(plan, A, B, C_ref) -> dict:
    phase("4c partial path")
    cm = CodedMatmul(plan, sub_tasks=Q_SUB)
    for counts in PROGRESS:
        pat = PartialPattern.from_progress(plan.K, Q_SUB, np.asarray(counts) / Q_SUB)
        gains = [float(np.abs(W).sum(1).max())
                 for W in cm.panel_cache.get_partial(pat.chunk_masks)]
        print(f"chunks done {counts}: coverage {pat.coverage.tolist()}, per-chunk "
              f"panel gain {[round(g, 2) for g in gains]}")
    out = drive("partial", [(f"progress={c}/{Q_SUB}",
                             lambda c=c: cm(A, B, progress=np.asarray(c) / Q_SUB))
                            for c in PROGRESS],
                C_ref, cm, {"fused_worker": 1, "decode_partial": 1})
    binary = drive("partial Q=1", [(f"erased={ERASURES[1]}",
                                    lambda: cm(A, B, erased=ERASURES[1], sub_tasks=1))],
                   C_ref, cm, {"fused_worker": 1, "decode": 1})
    # one split-stage pair: the worker stage, then the decode of its products
    ops.reset_launch_counts()
    Y = cm.worker_stage(A, B)
    torch.cuda.synchronize()
    stage_counts = ops.launch_counts()
    C = cm.decode_stage(Y, (R, T), erased=ERASURES[0])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(torch.equal(C, C_ref) and torch.equal(C, cm(A, B, erased=ERASURES[0], sub_tasks=1)),
          "worker_stage + decode_stage differs from the one-shot call")
    want = dict.fromkeys(counts, 0) | {"fused_worker": 1, "decode": 1}
    check(counts == want and stage_counts["fused_worker"] == 1,
          f"split stages launched {counts}, not {want}")
    print(f"split stages erased={ERASURES[0]}: worker_stage {tuple(Y.shape)} + "
          f"decode_stage exact, equal to the one-shot call; launches "
          f"{({k: v for k, v in counts.items() if v})}, cache {cm.cache_info()}")
    for k, v in binary["counts"].items():
        out["counts"][k] += v + counts[k]
    return out


def times_phase(plan, A, B) -> dict:
    phase("5 times")
    ca, cb, a4, b4 = fused_inputs(plan, A, B, torch.float64)
    K, P, Q = plan.K, ca.shape[1], cb.shape[1]
    v, r, t = a4.shape[-2], a4.shape[-1], b4.shape[-1]

    def bound(flops: float, nbytes: float, by: str) -> dict:
        return {"bound_ms": max(flops / PEAK_FP64_TENSOR, nbytes / PEAK_HBM) * 1e3,
                "bound_by": by}

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
    fused |= bound(flops, nbytes, "operations")
    print(f"fused_worker: {flops:.4g} FLOP, {nbytes:.4g} B; bound "
          f"{fused['bound_ms']:.3f} ms at FP64 tensor peak "
          f"({flops / PEAK_FP64_VECTOR * 1e3:.3f} ms at FP64 vector peak); "
          f"kernel {fused['ms']:.3f} ms, plain {fused['plain_ms']:.3f} ms, "
          f"einsum+bmm {fused['library_ms']:.3f} ms")

    # encode: the kernel reads the strided block view; the plain version and
    # torch.matmul get the (P, E) stack made beforehand (their reshape would
    # copy 512 MB inside the timing)
    stack = a4.reshape(P, -1)
    enc = dict(
        ms=time_ms(lambda: ops.encode(ca, a4), 20),
        plain_ms=time_ms(lambda: ref.encode_ref(ca, stack), 20),
        library_ms=time_ms(lambda: torch.matmul(ca, stack), 20))
    E = v * r
    flops, nbytes = 2 * K * P * E, 8 * (P * E + K * E + K * P)
    enc |= bound(flops, nbytes, "bytes")
    print(f"encode: {flops:.4g} FLOP, {nbytes:.4g} B; bound {enc['bound_ms']:.3f} ms at "
          f"HBM peak; kernel {enc['ms']:.3f} ms ({nbytes / enc['ms'] / 1e6:.1f} GB/s), "
          f"plain {enc['plain_ms']:.3f} ms, torch.matmul {enc['library_ms']:.3f} ms")
    del stack

    at, bt = ops.encode(ca, a4), ops.encode(cb, b4)
    a1, b1 = at[0], bt[0]
    mm = dict(
        ms=time_ms(lambda: ops.matmul_t(a1, b1), 5),
        plain_ms=time_ms(lambda: ref.matmul_t_ref(a1, b1), 5),
        library_ms=time_ms(lambda: a1.T @ b1, 5))
    flops, nbytes = 2 * v * r * t, 8 * (v * r + v * t + r * t)
    mm |= bound(flops, nbytes, "operations")
    print(f"matmul_t: {flops:.4g} FLOP, {nbytes:.4g} B; bound {mm['bound_ms']:.3f} ms at "
          f"FP64 tensor peak ({flops / PEAK_FP64_VECTOR * 1e3:.3f} ms at FP64 vector "
          f"peak); kernel {mm['ms']:.3f} ms, plain {mm['plain_ms']:.3f} ms (A.T @ B: the "
          f"plain version is the library call), A.T @ B {mm['library_ms']:.3f} ms")
    del at, bt, a1, b1

    Y = ops.fused_worker(ca, cb, a4, b4).reshape(K, -1)
    del ca, cb, a4, b4
    W = torch.as_tensor(plan.make_panel_cache().get(np.ones(K)).W, device="cuda")
    mn, E, s = W.shape[0], Y.shape[1], plan.s

    def extract(X):
        C_hat = torch.remainder(torch.round(X), s)
        return torch.where(C_hat <= s / 2, C_hat, C_hat - s)

    dec = dict(
        ms=time_ms(lambda: ops.decode(W, Y, s), 20),
        plain_ms=time_ms(lambda: ref.decode_ref(W, Y, s), 20),
        library_ms=time_ms(lambda: extract(torch.matmul(W, Y)), 20))
    flops, nbytes = 2 * mn * K * E, 8 * (K * E + mn * K + mn * E)
    dec |= bound(flops, nbytes, "bytes")
    print(f"decode: {flops:.4g} FLOP, {nbytes:.4g} B; bound {dec['bound_ms']:.3f} ms "
          f"at HBM peak; kernel {dec['ms']:.3f} ms ({nbytes / dec['ms'] / 1e6:.1f} "
          f"GB/s), plain {dec['plain_ms']:.3f} ms, matmul+extract "
          f"{dec['library_ms']:.3f} ms")

    pat = PartialPattern.from_progress(K, Q_SUB, np.asarray(PROGRESS[0]) / Q_SUB)
    W_stack = torch.as_tensor(plan.make_panel_cache().get_partial(pat.chunk_masks),
                              device="cuda")
    cols = [b * t for b in chunk_bounds(r, Q_SUB)]

    def library_partial():
        return torch.cat([extract(torch.matmul(W_stack[q], Y[:, cols[q]:cols[q + 1]]))
                          for q in range(Q_SUB)], dim=1)

    part = dict(
        ms=time_ms(lambda: ops.decode_partial(W_stack, Y, s, bounds=cols), 20),
        plain_ms=time_ms(lambda: ref.decode_partial_ref(W_stack, Y, s, True, cols), 20),
        library_ms=time_ms(library_partial, 20))
    flops, nbytes = 2 * mn * K * E, 8 * (K * E + Q_SUB * mn * K + mn * E)
    part |= bound(flops, nbytes, "bytes")
    print(f"decode_partial (Q={Q_SUB}): {flops:.4g} FLOP, {nbytes:.4g} B; bound "
          f"{part['bound_ms']:.3f} ms at HBM peak; kernel {part['ms']:.3f} ms "
          f"({nbytes / part['ms'] / 1e6:.1f} GB/s), plain {part['plain_ms']:.3f} ms, "
          f"per-chunk matmul+extract {part['library_ms']:.3f} ms")
    return {"fused_worker": fused, "decode": dec, "encode": enc, "matmul_t": mm,
            "decode_partial": part}


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
    C_ref = A.T @ B  # exact: every partial sum is an integer below 2^53
    paths = {"fused": main_phase(plan, A, B, C_ref),
             "staged": staged_phase(plan, A, B, C_ref),
             "partial": partial_phase(plan, A, B, C_ref)}
    times = times_phase(plan, A, B)
    for name, path in paths.items():
        wall = path["walls"]
        print(f"request wall time ({name}, 8000^2, float64): first {wall[0]:.2f} ms, "
              f"median of the rest {float(np.median(wall[1:])):.2f} ms on {dev['smi']}")

    csrc = "src/repro_torch/kernels/csrc"
    source = {"fused_worker": (f"{csrc}/coded_fused.cu", "src/repro/kernels/coded_fused.py:105"),
              "decode": (f"{csrc}/coded_decode.cu", "src/repro/kernels/coded_decode.py:57"),
              "decode_partial": (f"{csrc}/coded_decode.cu",
                                 "src/repro/kernels/coded_decode.py:106"),
              "encode": (f"{csrc}/coded_encode.cu", "src/repro/kernels/coded_encode.py:48"),
              "matmul_t": (f"{csrc}/block_matmul.cu", "src/repro/kernels/block_matmul.py:62")}
    launches = {k: sum(path["counts"][k] for path in paths.values()) for k in KERNELS}
    kernels = [dict(name=name, route="cuda", source=source[name][0],
                    replaces=source[name][1], launches=launches[name],
                    max_abs_err=errs[name], **times[name])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
