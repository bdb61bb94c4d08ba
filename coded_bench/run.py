"""Run one cell of ``BENCHMARK.json`` and print its result as one JSON line.

    python -m coded_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness only drives: every part of a cell is a file found by name
(``spec``).  Set-up builds the configuration's problem (its operands, made
on the card from the seed), the mix's entry (the program's objects, warmed
on the shapes the cell uses; the program's decode-panel cache is not
filled: its misses are part of the traffic) and the request stream.  The
mix's loop then serves requests for ``--seconds``.  Once the window has
closed, the metrics are read, the program is freed, and the problem
compares its sample of the window's answers with the plain reference.

With ``--trace 1`` the per-layer metrics are read instead of the
end-to-end ones, and ``torch.profiler`` traces the middle fifth of the
window.  ``--control float32`` runs the program's own float32 path: the
check must then come out false.

Build and kernel caches stay in ``build/`` inside the checkout; the
program's thread pools keep the defaults its own entry points run with.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through libraries."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def _port_on_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


class Context:
    """What the problem, the entry, the loop and the metric readers of one
    run see."""

    def __init__(self, cell, cfg, mix, seed, seconds, trace, device, dtype, chips):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.dtype, self.chips = device, dtype, chips
        self.problem = self.entry = self.tracer = None
        self.latencies: list = []
        self.errors: list = []
        self.completed = self.failed = 0
        self.window_s = self.setup_s = 0.0
        self.counters_before = self.counters_after = {}
        self.profile = None          # trace.reduce's dict, --trace 1
        self.state: dict = {}        # readers' own measurements

    def sync(self) -> None:
        """Wait for the card (nothing on the CPU)."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def done(self, req, answer, latency: float) -> None:
        """Record one answered request (the loop calls it)."""
        self.latencies.append(latency)
        self.completed += 1
        self.problem.keep(req, answer, self.entry.served(req))


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", control: str | None = None,
             overrides: dict | None = None, bench: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last).

    ``device="cpu"`` runs the program's plain CPU path (tests);
    ``overrides`` replace configuration keys (tests, at small sizes).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    _port_on_path()
    import torch

    from coded_bench import spec, traffic
    from coded_bench import trace as tracing

    bench = bench or spec.benchmark()
    work = spec.workload(bench, cell)
    cfg = dict(spec.config(bench, work["config"]), **(overrides or {}))
    mix = spec.mix(work["traffic"])
    dev = torch.device(device)
    dtype = {None: torch.float64, "float32": torch.float32}[control]
    ctx = Context(cell, cfg, mix, seed, seconds, trace, dev, dtype, work["chips"])
    section = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: spec.module("metrics", m["name"])
               for m in spec.metrics(bench, cell, section)}
    loop = spec.module("loops", mix["loop"])

    # -- set-up --------------------------------------------------------------
    ctx.problem = spec.module("problems", cfg["problem"]).Problem(ctx)
    ctx.entry = spec.module("entries", mix["entry"]).Entry(ctx)
    ctx.entry.warm(*ctx.problem.inputs(0))
    ctx.problem.start(ctx.entry.taus)
    stream = traffic.requests(mix, cfg["K"], ctx.entry.tau, seed)
    stream = itertools.chain([next(stream)], stream)    # first draws in set-up
    ctx.tracer = tracing.Tracer(trace, dev, seconds)
    if trace:
        ctx.entry.instrument()
        with tracing.profiler(dev):
            torch.ones(8, device=dev).add_(1)
            ctx.sync()
    for reader in readers.values():
        if hasattr(reader, "prepare"):
            reader.prepare(ctx)
    ctx.counters_before = dict(ctx.entry.counters())
    ctx.sync()
    ctx.setup_s = time.perf_counter() - t_start

    # -- the window ------------------------------------------------------------
    loop.serve(ctx, stream)
    ctx.counters_after = dict(ctx.entry.counters())
    ctx.profile = ctx.tracer.result

    # -- metrics, then the program is freed ------------------------------------
    metrics = {}
    for m in spec.metrics(bench, cell, section):
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ctx.sync()
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
                   "count": ctx.chips,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    if trace:
        prof_info = ctx.profile or {"busy_s": 0.0, "window_s": 0.0}
        device_info["busy_s"] = prof_info["busy_s"]
        device_info["window_s"] = prof_info["window_s"]
    device_info["power_limit_w"] = _power_limit() if dev.type == "cuda" else None
    ctx.entry.close()
    ctx.entry = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the comparison with the plain reference --------------------------------
    correct, checks = ctx.problem.judge(ctx.failed)
    result = {"correct": bool(correct),
              "attempted": ctx.completed + ctx.failed,
              "failed": ctx.failed,
              "metrics": metrics,
              "device": device_info}
    if trace and ctx.profile is not None:
        result["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                               "idle_gaps": ctx.profile["idle_gaps"]}
    result["checks"] = checks
    for text in ctx.errors[:3]:
        print(text, file=sys.stderr)
    return result


def _loaded_forbidden(modules=None) -> list:
    """Top-level names of ``modules`` (default: the loaded ones) that are
    JAX's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("float32",), default=None,
                    help="run the program's float32 path: must read incorrect")
    args = ap.parse_args(argv)
    _environment()
    from coded_bench import spec

    bench = spec.benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"coded_bench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      control=args.control, bench=bench, t_start=T_START)
    found = _loaded_forbidden()
    if found:
        print(f"coded_bench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        bound = (f"limit {check['limit']}" if "limit" in check
                 else f"at least {check['at_least']}")
        print(f"check {name}: {check['value']} ({bound})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
