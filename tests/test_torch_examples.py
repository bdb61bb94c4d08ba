"""The port's example and bench twins on the CPU: the twin of
``tests/test_integration.py::TestExamples`` (the quickstart), the kernel
micro-bench's ``--check`` gate, the runtime bench's rows and the harness,
which writes only to its ``--out``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from benchmarks import torch_kernels_micro, torch_runtime_bench

ROOT = Path(__file__).resolve().parents[1]


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=str(ROOT))
    assert p.returncode == 0, f"{args}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}"
    return p.stdout


class TestExamples:
    def test_quickstart(self):
        out = _run([str(ROOT / "examples" / "torch_quickstart.py"), "--device", "cpu"])
        assert "exact recovery" in out


def test_kernels_micro_check_on_the_cpu():
    """On the CPU the gate holds the plain fused worker against the einsum
    definition (on the card: the kernel against the plain version)."""
    assert torch_kernels_micro.check(torch.device("cpu")) < torch_kernels_micro.CHECK_TOL


def test_runtime_bench_builds_one_pipeline_per_backend():
    rows = torch_runtime_bench.run(torch.device("cpu"))
    assert [r["backend"] for r in rows] == ["reference", "staged", "fused", "mesh"]
    for r in rows:
        assert r["executables"] == r["builds"] == 1, r
        assert r["warm_patterns"] == 4


def test_harness_writes_only_its_out(tmp_path):
    bench_files = {p: p.stat().st_mtime_ns for p in ROOT.glob("BENCH_*.json")}
    out = tmp_path / "bench.json"
    text = _run(["-m", "benchmarks.torch_run", "--device", "cpu", "--out", str(out)])
    sections = json.loads(out.read_text())
    assert set(sections) == {"fig1_latency", "table1_error", "tradeoff_sweep", "kernels_micro",
                             "runtime_bench", "roofline"}
    assert len(sections["kernels_micro"]) == 9 and len(sections["runtime_bench"]) == 4
    assert "total bench time" in text
    assert {p: p.stat().st_mtime_ns for p in ROOT.glob("BENCH_*.json")} == bench_files
