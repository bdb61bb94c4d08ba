"""Benchmark harness over the port's twins: one section per paper table or
figure, the kernel micro-benches, the runtime bench and the roofline.

The twin of ``benchmarks/run.py``.  Each section prints its CSV rows; with
``--out`` every section's rows go into one JSON file there (and nowhere
else: no ``BENCH_*.json`` is written).  On the CPU (``--device cpu``) the
times are the plain versions' and say nothing of the card.

Usage:
  python -m benchmarks.torch_run                    # the card
  python -m benchmarks.torch_run --device cpu --out build/bench.json
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", help="write every section's rows here (JSON)")
    args = ap.parse_args(argv)
    dev = [] if args.device is None else ["--device", args.device]
    t0 = time.time()
    sections = {}

    print("== fig1_latency (paper Fig. 1: latency vs stragglers) ==")
    from benchmarks import torch_fig1_latency
    sections["fig1_latency"] = torch_fig1_latency.main(dev)

    print("\n== table1_error (paper Table I: decode error vs bound L) ==")
    from benchmarks import torch_table1_error
    sections["table1_error"] = torch_table1_error.main(dev)

    print("\n== tradeoff_sweep (paper Sec. IV: tau vs headroom) ==")
    from benchmarks import torch_tradeoff_sweep
    sections["tradeoff_sweep"] = torch_tradeoff_sweep.main(dev)

    print("\n== kernels_micro (the CUDA kernels beside their plain versions) ==")
    from benchmarks import torch_kernels_micro
    sections["kernels_micro"] = [
        {"name": name, "us": us, "derived": derived}
        for name, us, derived in torch_kernels_micro.main(dev)]

    print("\n== runtime_bench (cold vs warm calls per backend) ==")
    from benchmarks import torch_runtime_bench
    sections["runtime_bench"] = torch_runtime_bench.main(dev)

    print("\n== roofline (from the dry-run cells) ==")
    from benchmarks import torch_roofline
    sections["roofline"] = torch_roofline.main()

    print(f"\ntotal bench time: {time.time() - t0:.1f}s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(sections, f, indent=2, default=str)
            f.write("\n")
        print(f"saved {args.out}")
    return sections


if __name__ == "__main__":
    main()
