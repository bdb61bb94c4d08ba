"""``examples/torch_train_lm.py`` (the twin of ``examples/train_lm.py``) on
the CPU: the ``--quick`` run (2 layers of the ~100M geometry, 60 steps of 8
x 256 tokens) must learn the pipeline's bigram stream, ending well below
the ln(vocab) floor, as ``tests/test_integration.py`` asks of the
reference's example.

The example runs in a child process with two math threads: the suite runs
six workers on the machine's cores, and a child with a thread per core
oversubscribes them (60 steps then took over 300 s instead of 27).
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 300


def test_train_lm_twin_learns_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
                           "--quick", "--device", "cpu"], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    assert "arch=repro-100m params=0.7M batch=8 seq=256 device=cpu" in out
    assert "random floor ln(V) = 6.931" in out
    assert out.rstrip().endswith("learned successfully.")
