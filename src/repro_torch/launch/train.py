"""Training entry point: data pipeline -> train step -> checkpoints.

Runs on the CUDA card unless ``--device cpu`` is given.  Fault tolerance:
periodic atomic checkpoints (parameters, optimizer state and the data
stream's step); ``--resume`` restarts from the newest committed step and
replays the exact data stream (batch t is a pure function of the seed and
t).

Elastic shrink (``--elastic-shrink-at N --elastic-devices D``): simulate a
device loss before step N: checkpoint, ``plan_shrink(D)`` picks the
largest supported mesh that fits, the train step is rebuilt and the state
restored from the checkpoint just written.  The port has no sharding rules
yet (ROADMAP.md queue 1, item 8.6), so the rebuild always takes the
single-device path, as the reference does on a host with fewer than d * m
devices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.numerics import resolve_device
from repro_torch.data import make_pipeline
from repro_torch.distributed.elastic import plan_shrink
from repro_torch.launch.serve import stub_embeds
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ModelConfig, init_params
from repro_torch.optim import OptConfig, adamw_init

__all__ = ["build", "main", "to_batch"]


def build(arch: str, smoke: bool, seq: int, batch: int, lr: float, steps: int,
          mesh=None):
    """(config, train step, data pipeline) for a run.

    Raises:
        NotImplementedError: given a ``mesh``: the sharding rules a mesh
            needs are not ported yet (ROADMAP.md queue 1, item 8.6).
    """
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh needs the sharding rules, which are not ported "
            "yet (ROADMAP.md queue 1, item 8.6)")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(2, steps // 20), total_steps=steps)
    return cfg, make_train_step(cfg, opt_cfg), make_pipeline(cfg.vocab, seq, batch)


def to_batch(cfg: ModelConfig, arrays: dict, device) -> dict:
    """A pipeline batch (numpy tokens and labels) as the model's input on
    ``device``: embedding-input configs get the serve CLI's
    ``stub_embeds`` of the tokens, and for multimodal rope ``pos_ids`` =
    arange(S) on all three axes, as the reference's trainer makes them."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    if cfg.input_mode == "embeds":
        tok = batch.pop("tokens")
        batch["embeds"] = stub_embeds(tok, cfg.d_model)
        if cfg.pos == "mrope":
            B, S = tok.shape
            batch["pos_ids"] = torch.arange(S, dtype=torch.int32,
                                            device=device).expand(3, B, S)
    return batch


def _elastic_handoff(args, params, opt_state, t: int):
    """Execute the shrink: checkpoint at step ``t``, plan the mesh, rebuild
    the step, restore from the checkpoint just written."""
    save_checkpoint(args.ckpt_dir, t, (params, opt_state), extra={"data_step": t})
    d, m = plan_shrink(args.elastic_devices)
    _, step_fn, _ = build(args.arch, args.smoke, args.seq, args.batch, args.lr, args.steps)
    (params, opt_state), _, _ = restore_checkpoint(args.ckpt_dir, (params, opt_state))
    print(f"elastic shrink at step {t}: {args.elastic_devices} healthy devices -> mesh "
          f"({d}, {m}) (single-device lowering); re-lowered and restored", flush=True)
    return step_fn, params, opt_state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--elastic-shrink-at", type=int, default=None,
                    help="simulate losing devices BEFORE this step: checkpoint, "
                         "plan_shrink the mesh, rebuild, restore, continue")
    ap.add_argument("--elastic-devices", type=int, default=None,
                    help="healthy device count after the simulated loss "
                         "(required with --elastic-shrink-at)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.elastic_shrink_at is not None:
        if args.elastic_devices is None or args.ckpt_dir is None:
            ap.error("--elastic-shrink-at requires --elastic-devices and "
                     "--ckpt-dir (the handoff restores from checkpoint)")
        if not 0 < args.elastic_shrink_at < args.steps:
            ap.error(f"--elastic-shrink-at {args.elastic_shrink_at} outside "
                     f"(0, {args.steps})")

    dev = resolve_device(args.device)
    if dev.type == "cuda":      # float32 products in float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, step_fn, pipe = build(args.arch, args.smoke, args.seq, args.batch, args.lr,
                               args.steps)
    params = init_params(cfg, seed=args.seed, device=dev)
    opt_state = adamw_init(params)
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start, _ = restore_checkpoint(args.ckpt_dir, (params, opt_state))
        print(f"resumed from step {start}")

    n_params = sum(p.numel() for p in params.parameters())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M batch={args.batch} "
          f"seq={args.seq} device={where}")

    losses = []
    t0 = time.time()
    for t in range(start, args.steps):
        if args.elastic_shrink_at is not None and t == args.elastic_shrink_at:
            step_fn, params, opt_state = _elastic_handoff(args, params, opt_state, t)
        batch = to_batch(cfg, pipe.batch(t), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if t % args.log_every == 0 or t == args.steps - 1:
            print(f"step {t:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (t + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, t + 1, (params, opt_state),
                            extra={"data_step": t + 1})
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, (params, opt_state),
                        extra={"data_step": args.steps})
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
