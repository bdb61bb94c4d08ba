"""End-to-end run: train a ~100M-parameter LM for a few hundred steps
with the port (twin of ``examples/train_lm.py``).

Uses the port's whole training stack - the synthetic-but-learnable data
pipeline, the transformer with each layer checkpointed, AdamW with float32
masters, atomic checkpoints - on a qwen3-family geometry scaled to ~100M
parameters.  The loss must drop well below the ln(vocab) random floor.
Runs on the CUDA card unless ``--device cpu`` is given.

Run:    python examples/torch_train_lm.py
Quick:  python examples/torch_train_lm.py --quick --device cpu
"""
import argparse
import dataclasses
import math
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402

# ~100M params: 12L x d512 x ff2048, vocab 8192 (tied) -> ~0.1B
CFG_100M = ModelConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_head=64,
    d_ff=2048,
    vocab=8192,
    pattern=(("attn", "mlp"),),
    qk_norm=True,
    rope_theta=1e4,
    tie_embeddings=True,
    q_chunk=128,
    kv_chunk=256,
    loss_chunk=128,
    tp_pad=1,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny run for CI (2 layers, 60 steps)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = CFG_100M
    steps = args.steps
    lr = "2e-3"
    if args.quick:
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=512,
                                  n_heads=4, n_kv_heads=2, vocab=1024)
        steps = 60
        lr = "5e-3"
    # register the config under a module name the registry loads
    mod = type(sys)("repro_torch.configs._train_lm_example")
    mod.CONFIG = cfg
    mod.SMOKE = cfg
    sys.modules["repro_torch.configs._train_lm_example"] = mod

    device = ["--device", args.device] if args.device else []
    with tempfile.TemporaryDirectory() as tmp:
        losses = train_main([
            "--arch", "_train_lm_example", "--steps", str(steps),
            "--batch", "8", "--seq", "256", "--lr", lr,
            "--ckpt-dir", args.ckpt_dir or tmp, "--ckpt-every", "100",
            "--log-every", "10", *device,
        ])
    floor = math.log(cfg.vocab)
    print(f"random floor ln(V) = {floor:.3f}; final = {losses[-1]:.3f}")
    assert losses[-1] < floor - 0.3, "model failed to learn"
    print("learned successfully.")
    return losses


if __name__ == "__main__":
    main()
