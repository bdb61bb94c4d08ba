"""Where kernel 1's time goes in bf16: the kernel beside copies of it with
parts cut out, at the paper's worker stage.

Kernel 1's 16-bit TMA form (``src/repro_torch/kernels/csrc/coded_fused.cu``)
overlaps three kinds of work on one SM: TMA loads of the raw tiles, the
encode on the CUDA cores, and the wgmma products.  No profiler that could
split them runs on the card's machine, so this script builds copies of the
source with one or more of them cut out (a text edit of the source; the
results are wrong, the timing is what counts) and times each beside the
kernel, in turns, with CUDA events:

- ``kernel``: the source as it is;
- ``no_products``: the wgmma calls cut;
- ``no_loads``: the TMA copies cut (each stage's barrier expects 0 bytes);
- ``encode_only``: loads and products cut;
- ``loads_only``: encode and products cut;
- ``sync_only``: all three cut: the rings' barriers, the loop and the
  epilogue.

Shapes: K = 10 workers, P = Q = 4 blocks of 4000 x 4000 as strided views of
8000 x 8000 bf16 matrices (``chip_smoke.py``'s paper-8000-half).  Prints
the card's name and power limit, one line per variant and round, and a
JSON line of the medians.  Needs one CUDA card and nvcc.

Run:  PYTHONPATH=src python -m benchmarks.torch_fused_breakdown [--rounds 2]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import types

import torch

from repro_torch.core.partition import block_decompose
from repro_torch.kernels import _build, coded_fused

SOURCE = _build._CSRC / "coded_fused.cu"
OUT_DIR = _build.BUILD_DIR / "breakdown"

# (text in the source, its replacement) for each part that can be cut
_CUTS = {
    "loads": [
        ("if (lane == 0) async_copy::arrive_expect_bytes(&full[slot], (na + nb) * L::kTileBytes);",
         "if (lane == 0) async_copy::arrive_expect_bytes(&full[slot], 0);"),
        ("async_copy::tensor_copy(s + ", "if (false) async_copy::tensor_copy(s + "),
    ],
    "encode": [("  uint4 x[L::kVecsPerThread][kN];",
                "  if (true) return;\n  uint4 x[L::kVecsPerThread][kN];")],
    "products": [("wg::mma<T>(acc[band],", "if (false) wg::mma<T>(acc[band],")],
}
VARIANTS = {
    "kernel": (),
    "no_products": ("products",),
    "no_loads": ("loads",),
    "encode_only": ("loads", "products"),
    "loads_only": ("encode", "products"),
    "sync_only": ("loads", "encode", "products"),
}


def variant_sources() -> dict:
    """{variant: source text}: the kernel's source with the variant's parts
    cut.  Raises ValueError if a cut no longer matches the source."""
    text = SOURCE.read_text()
    out = {}
    for name, parts in VARIANTS.items():
        src = text
        for part in parts:
            for old, new in _CUTS[part]:
                if old not in src:
                    raise ValueError(f"cut {part!r} no longer matches {SOURCE.name}: {old!r}")
                src = src.replace(old, new)
        out[name] = src
    return out


def build(sources: dict, out_dir=OUT_DIR) -> dict:
    """{variant: loaded library}, one nvcc per variant, all at once, into
    ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    running = []
    for name, src in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *flags, "-I", str(_build._CSRC), "-o", str(lib), str(path)]
        running.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in running:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def time_ms(fn, n: int) -> float:
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_fused_breakdown needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(variant_sources())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dt = torch.bfloat16
    ca = torch.randn((10, 4), generator=gen, device="cuda").to(dt)
    cb = torch.randn((10, 4), generator=gen, device="cuda").to(dt)
    a4 = block_decompose(torch.randn((8000, 8000), generator=gen, device="cuda").to(dt), 2, 2)
    b4 = block_decompose(torch.randn((8000, 8000), generator=gen, device="cuda").to(dt), 2, 2)
    times = {name: [] for name in libs}
    wrapper_build = coded_fused._build
    try:
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                coded_fused._build = types.SimpleNamespace(load=lambda _name, lib=lib: lib)
                ms = time_ms(lambda: coded_fused.fused_worker_cuda(ca, cb, a4, b4), 5)
                times[name].append(ms)
                print(f"round {rnd} {name}: {ms:.4f} ms", flush=True)
    finally:
        coded_fused._build = wrapper_build
    medians = {name: statistics.median(ms) for name, ms in times.items()}
    print(json.dumps({"card": smi, "dtype": "bf16", "shape": "K=10, P=Q=4, 4000^3",
                      "median_ms": medians}))
    return medians


if __name__ == "__main__":
    main()
