"""The mesh paths of the port's bench twin and straggler example on CPU
ranks (gloo), against the reference's recorded rows.

``benchmarks/torch_control_bench.py partial_sweep --backend mesh`` spawns a
(1, 12) mesh and replays the reference's strict-win scenarios; its rows
must equal ``BENCH_control.json["partial_sweep_mesh"]``, which the JAX
bench wrote from its own 12-device mesh.  ``examples/torch_straggler_sim.py``
serves three lost-chip sets on a (2, 4) mesh.  Each spawn has a deadline.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmarks import torch_control_bench as bench

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120


def test_control_bench_partial_sweep_mesh_check(monkeypatch, capsys):
    monkeypatch.setattr(bench, "MESH_TIMEOUT_S", DEADLINE_S)
    result = bench.main(["partial_sweep", "--backend", "mesh", "--check",
                         "--device", "cpu"])
    want = json.loads((ROOT / "BENCH_control.json").read_text())
    assert result["partial_sweep_mesh"] == want["partial_sweep_mesh"]
    assert result["config"]["partial_sweep_mesh"] == want["config"]["partial_sweep_mesh"]
    text = capsys.readouterr().out
    assert "control bench check (partial_sweep, mesh): OK" in text
    assert text.count("partial [mesh]") == 2


def test_straggler_example_on_cpu_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_straggler_sim.py"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for lost in ("none", "[2]", "[0, 1]"):
        assert any(line.startswith(f"lost chips {lost}") and line.endswith("(exact)")
                   for line in lines), proc.stdout
    assert "on each of 8 ranks from 1 pipeline build(s)" in proc.stdout
    assert "bec (tau=4)" in proc.stdout and "polycode (tau=9)" in proc.stdout
