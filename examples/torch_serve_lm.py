"""Serving example on the PyTorch/CUDA port: batched prefill + greedy decode
with the smoke Qwen3 config, plus a coded (straggler-tolerant) lm_head.

Part 1 serves ``qwen3_0_6b --smoke`` through ``repro_torch.launch.serve``.
Part 2 runs the lm_head ``y = x W`` through ``CodedLinearPlan`` (bec p=2
m=2 n=1, K=4, Chebyshev points, inputs quantised to 6 bits, float64) on a
(2, 4) mesh of ranks that ``launch/mesh.py`` spawns, one coded worker per
rank of the "model" axis: with every worker, then with worker 1 lost.  The
coded grid is exact, so the logits do not move.

Run:  python examples/torch_serve_lm.py                (on a CUDA card)
      python examples/torch_serve_lm.py --device cpu   (gloo CPU ranks)
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.core import make_plan  # noqa: E402
from repro_torch.distributed.coded import CodedLinearPlan  # noqa: E402
from repro_torch.launch.mesh import spawn_mesh  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402

D, V, B = 64, 512, 8          # hidden width, vocab, batch of final hiddens
LOST = (1.0, 0.0, 1.0, 1.0)   # worker 1 lost
MESH_TIMEOUT_S = 300


def coded_head(mesh) -> dict:
    """One rank's Part 2: argmax agreement and max logit drift between the
    coded lm_head with every worker and with worker 1 lost, and the
    facade's cache counters."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32)   # final hidden
    W = torch.as_tensor(rng.normal(size=(D, V)), dtype=torch.float32)   # lm head
    plan = make_plan("bec", p=2, m=2, n=1, K=4, L=D * 7 * 7 + 1, points="chebyshev")
    lin = CodedLinearPlan(plan, mesh, quant_bits=6, dtype=torch.float64)
    logits_ok = lin(x, W)
    logits_lost = lin(x, W, mask=torch.tensor(LOST, dtype=torch.float64))
    agree = float((logits_ok.argmax(-1) == logits_lost.argmax(-1)).float().mean())
    drift = float((logits_ok - logits_lost).abs().max())
    return {"agree": agree, "drift": drift, "info": lin.matmul.cache_info()}


def main(argv=None) -> dict:
    """Both parts; returns the served tokens, rank 0's coded-head result and
    every rank's output (``RankOutput``: result and launch counts)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]

    print("== batched serve (prefill + greedy decode) ==")
    tokens = serve_main(["--arch", "qwen3_0_6b", "--smoke", "--batch", "4",
                         "--prompt-len", "32", "--gen", "12"] + device)

    print("\n== coded lm_head: logits survive worker loss ==")
    outs = spawn_mesh(coded_head, data=2, model=4, device=args.device,
                      timeout_s=MESH_TIMEOUT_S)
    head = outs[0].result
    if any(out.result != head for out in outs):
        raise SystemExit("the mesh ranks served different logits")
    print(f"argmax agreement with a lost worker: {head['agree'] * 100:.0f}%  "
          f"(max logit drift {head['drift']:.2e} - the coded grid is erasure-invariant)")
    info = head["info"]
    print(f"runtime cache: {info['builds']} pipeline build(s), {info['hits']} cache "
          f"hits, {info['panel_builds']} decode panels (each of {len(outs)} ranks)")
    return {"tokens": tokens, "head": head, "outs": outs}


if __name__ == "__main__":
    main()
