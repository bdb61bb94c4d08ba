"""The trainer CLI on a mesh: ``torchrun`` starts four CPU ranks (gloo)
that join the (2, 2) ("data", "model") mesh ``plan_shrink(4)`` gives and train SMOKE
Qwen3 with the parameters and the AdamW state sharded by the reference's
rules; rank 0 prints and writes the checkpoints (the reference's layout,
gathered from the shards).  Its losses are the single-device run's within
the two layouts' bf16 rounding, and a resume on the mesh from its own
checkpoint repeats the run's last steps bit for bit.  The ranks' threads
are capped (``OMP_NUM_THREADS=2``), as the other child runs are."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch.checkpoint import latest_step
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3_0_6b", "--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
        "--log-every", "1", "--device", "cpu"]


def _torchrun(extra) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", *ARGS, *extra],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "mesh=(2, 2)" in proc.stdout
    return [float(m) for m in re.findall(r"^step +\d+ loss ([0-9.]+)", proc.stdout, re.M)]


def test_trainer_on_a_mesh_under_torchrun(tmp_path):
    ck = tmp_path / "ck"
    full = _torchrun(["--ckpt-dir", str(ck), "--ckpt-every", "2"])
    assert len(full) == 4 and latest_step(ck) == 4
    single = train.main(ARGS)
    np.testing.assert_allclose(full, single, rtol=1e-3)
    shutil.rmtree(ck / "step_000000004")
    resumed = _torchrun(["--ckpt-dir", str(ck), "--resume"])
    assert resumed == full[2:]
