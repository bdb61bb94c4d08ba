"""Where kernel 4's time goes in bf16 and f16: the kernel beside copies of
it with its loads or its stores cut, and beside designs tried for it, at
the paper's encode.

Kernel 4's 16-byte form (``src/repro_torch/kernels/csrc/coded_encode.cu``)
streams the raw blocks in with 16-byte loads and the coded blocks out with
16-byte stores, the FP32 sums between them.  No profiler that could split
them runs on the card's machine, so this script builds copies of the source
with one part changed (a text edit of the source; the cut variants' results
are wrong, the timing is what counts) and times each beside the kernel, in
turns, with CUDA events:

- ``kernel``: the source as it is (streaming stores, ``st.global.cs``);
- ``plain_stores``: plain ``st.global`` stores in their place;
- ``no_stores``: every store behind a test of the data that never passes,
  so the loads and sums still run;
- ``no_loads``: each 16-byte load replaced by values made from its address,
  so the sums and stores still run;
- ``no_allocate_loads``: the loads with the ``L1::no_allocate`` hint;
- ``prefetch``: a thread loads its next vector's raw blocks before it
  writes the current vector's coded ones (P <= 8), so loads stay in flight
  through the stores.

The last two are designs tried for the kernel (same results, bit for bit).

Beside them it times one torch device-to-device copy that moves as many
bytes (half read, half written): a measured ceiling, which the port never
calls.  Shapes: K = 10 workers, P = 4 blocks of 4000 x 4000 as strided
views of an 8000 x 8000 matrix (``chip_smoke.py``'s paper-8000-half).
Prints the card's name and power limit, one line per variant, dtype and
round, and a JSON line of the medians.  Needs one CUDA card and nvcc.

Run:  PYTHONPATH=src python -m benchmarks.torch_encode_breakdown [--rounds 3]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import types

import torch

from benchmarks.torch_fused_breakdown import build, time_ms
from repro_torch.core.partition import block_decompose
from repro_torch.kernels import _build, coded_encode

SOURCE = _build._CSRC / "coded_encode.cu"
OUT_DIR = _build.BUILD_DIR / "encode_breakdown"
K, GRID, N = 10, (2, 2), 8000

# The prefetch variant's loop for P <= 8, put before the kernel's own loop
_PREFETCH = """\
  if constexpr (kN > 0) {
    uint4 x[kN];
    if (row < rows) {
      const T* src = blocks + row * row_stride + vec * kVec;
#pragma unroll
      for (int j = 0; j < kN; ++j) x[j] = load16(src + offsets.v[j]);
    }
    while (row < rows) {
      T* dst = out + row * cols + vec * kVec;
      vec += step_vecs;
      row += step_rows;
      if (vec >= vecs) {
        vec -= vecs;
        ++row;
      }
      uint4 xn[kN];
      if (row < rows) {
        const T* src = blocks + row * row_stride + vec * kVec;
#pragma unroll
        for (int j = 0; j < kN; ++j) xn[j] = load16(src + offsets.v[j]);
      }
      for (int k = 0; k < K; ++k, dst += plane) {
        const float* c = c_s + k * kN;
        float s[1][8];
#pragma unroll
        for (int l = 0; l < 8; ++l) s[0][l] = 0.0f;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float cj[1] = {c[j]};
          accum::fma8<T, 1>(s, cj, x[j]);
        }
        uint4 y[1];
        accum::round8<T, 1>(s, y);
        store16(dst, y[0]);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) x[j] = xn[j];
    }
    return;
  }
"""

# (text in the source, its replacement) for each variant
_EDITS = {
    "plain_stores": [("  __stcs(static_cast<uint4*>(p), v);",
                      "  *static_cast<uint4*>(p) = v;")],
    "no_stores": [("  __stcs(static_cast<uint4*>(p), v);",
                   "  if (v.x == 0x7fc17fc3u && v.y == v.x && v.z == v.x && v.w == v.x)\n"
                   "    __stcs(static_cast<uint4*>(p), v);")],
    "no_loads": [("  return __ldg(static_cast<const uint4*>(p));",
                  "  const auto a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p));\n"
                  "  return make_uint4(a, a ^ 0x5555u, a + 0x3c00u, a * 5u);")],
    "no_allocate_loads": [("  return __ldg(static_cast<const uint4*>(p));",
                           "  uint4 v;\n"
                           "  asm volatile(\"ld.global.nc.L1::no_allocate.v4.u32 "
                           "{%0, %1, %2, %3}, [%4];\"\n"
                           "               : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), "
                           "\"=r\"(v.w) : \"l\"(p));\n"
                           "  return v;")],
    "prefetch": [("  while (row < rows) {\n", _PREFETCH + "  while (row < rows) {\n")],
}
VARIANTS = ("kernel", *_EDITS)


def variant_sources() -> dict:
    """{variant: source text}.  Raises ValueError if an edit no longer
    matches the source."""
    text = SOURCE.read_text()
    out = {"kernel": text}
    for name, edits in _EDITS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise ValueError(f"edit {name!r} no longer matches {SOURCE.name}: {old!r}")
            src = src.replace(old, new)
        out[name] = src
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_encode_breakdown needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(variant_sources(), OUT_DIR)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    P = GRID[0] * GRID[1]
    nbytes = 2 * (P + K) * (N // GRID[0]) * (N // GRID[1]) + 2 * K * P
    times = {}
    wrapper_build = coded_encode._build
    try:
        for dt in (torch.bfloat16, torch.float16):
            tag = "bf16" if dt == torch.bfloat16 else "f16"
            c = torch.randn((K, P), generator=gen, device="cuda").to(dt)
            a4 = block_decompose(torch.randn((N, N), generator=gen, device="cuda").to(dt), *GRID)
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
            dst = torch.empty_like(src)
            for rnd in range(args.rounds):
                for name, lib in libs.items():
                    coded_encode._build = types.SimpleNamespace(load=lambda _name, lib=lib: lib)
                    ms = time_ms(lambda: coded_encode.encode_cuda(c, a4), 20)
                    times.setdefault(f"{name}_{tag}", []).append(ms)
                    print(f"round {rnd} {name} {tag}: {ms:.4f} ms "
                          f"({nbytes / ms / 1e6:.1f} GB/s)", flush=True)
                ms = time_ms(lambda: dst.copy_(src), 20)
                times.setdefault(f"torch_copy_{tag}", []).append(ms)
                print(f"round {rnd} torch copy of {nbytes // 2} B: {ms:.4f} ms "
                      f"({nbytes / ms / 1e6:.1f} GB/s)", flush=True)
            del c, a4, src, dst
    finally:
        coded_encode._build = wrapper_build
    medians = {name: statistics.median(ms) for name, ms in times.items()}
    print(json.dumps({"card": smi, "shape": f"K={K}, P={P}, {N // GRID[0]}^2 strided views",
                      "bytes": nbytes, "median_ms": medians}))
    return medians


if __name__ == "__main__":
    main()
