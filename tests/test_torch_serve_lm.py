"""``examples/torch_serve_lm.py`` (the twin of ``examples/serve_lm.py``) on
the CPU: the smoke Qwen3 config served, then the coded lm_head on a (2, 4)
mesh of gloo ranks (one spawn, with a deadline).  As in the reference's
example, losing a worker moves no logit: 100% argmax agreement, zero
drift, and one pipeline build serves both erasure patterns on every rank.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120


def test_serve_lm_example_on_cpu_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_lm.py"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "arch=qwen3-0.6b-smoke batch=4 prompt=32 gen=12 device=cpu" in out
    assert "argmax agreement with a lost worker: 100%  (max logit drift 0.00e+00" in out
    assert "runtime cache: 1 pipeline build(s), 1 cache hits, 2 decode panels " \
           "(each of 8 ranks)" in out
