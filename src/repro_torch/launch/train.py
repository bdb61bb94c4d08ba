"""Training entry point: data pipeline -> train step -> checkpoints.

Runs on the CUDA card unless ``--device cpu`` is given.  Fault tolerance:
periodic atomic checkpoints (parameters, optimizer state and the data
stream's step); ``--resume`` restarts from the newest committed step and
replays the exact data stream (batch t is a pure function of the seed and
t).

On a mesh: under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) every
process joins the launcher's group as a rank of the ("data", "model") mesh
that ``plan_shrink`` gives the world size (``launch/mesh.py::join_mesh``;
a world size that no supported mesh equals is refused), the parameters
and the optimizer state are sharded by the reference's rules (FSDP + TP + EP,
``distributed/param_sharding.py``) and each rank runs the train step on its
shards; rank 0 prints and writes the checkpoints.  Without torchrun the run
is single-device, as the reference's is on a host with one device.

Elastic shrink (``--elastic-shrink-at N --elastic-devices D``): simulate a
device loss before step N: checkpoint, ``plan_shrink(D)`` picks the
largest supported mesh that fits, the train step is rebuilt and the state
restored from the checkpoint just written.  The rebuild takes that mesh
when the run's ranks make it up exactly (the reference's debug mesh when
the host has the devices), else the single-device path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3_0_6b --smoke --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.numerics import resolve_device
from repro_torch.data import make_pipeline
from repro_torch.distributed.elastic import plan_shrink
from repro_torch.distributed.param_sharding import shard_params
from repro_torch.distributed.sharding import default_rules
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.serve import stub_embeds
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ModelConfig, init_params
from repro_torch.optim import OptConfig, adamw_init

__all__ = ["build", "main", "to_batch"]


def build(arch: str, smoke: bool, seq: int, batch: int, lr: float, steps: int,
          mesh=None):
    """(config, train step, data pipeline) for a run; given a ``mesh`` (a
    ("data", "model") ``DeviceMesh``), the step runs under the reference's
    ``default_rules`` on it."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(2, steps // 20), total_steps=steps)
    rules = default_rules(mesh) if mesh is not None else None
    return (cfg, make_train_step(cfg, opt_cfg, rules),
            make_pipeline(cfg.vocab, seq, batch))


def _init_state(cfg: ModelConfig, seed: int, dev, mesh):
    """(params, AdamW state), sharded on ``mesh`` when one is given (every
    rank draws the same values from the seed and keeps its shards)."""
    params = init_params(cfg, seed=seed, device=dev)
    if mesh is not None:
        shard_params(params, default_rules(mesh))
    return params, adamw_init(params)


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


def _elastic_handoff(args, cfg, params, opt_state, t: int, dev, mesh):
    """Execute the shrink: checkpoint at step ``t``, plan the mesh, rebuild
    the step on it (when this run's ranks make up that mesh exactly, else
    on the single-device path), restore from the checkpoint just written.
    Returns (step, params, opt state, mesh)."""
    save_checkpoint(args.ckpt_dir, t, (params, opt_state), extra={"data_step": t})
    d, m = plan_shrink(args.elastic_devices)
    world = mesh.size() if mesh is not None else 1
    new_mesh = None
    if d * m > 1 and world == d * m:
        new_mesh = mesh_mod.make_debug_mesh(d, m, dev.type)
    _, step_fn, _ = build(args.arch, args.smoke, args.seq, args.batch, args.lr, args.steps,
                          mesh=new_mesh)
    # the state laid out for the new step: in place on one device, else
    # placed anew on the new mesh
    template = ((params, opt_state) if mesh is None and new_mesh is None
                else _init_state(cfg, args.seed, dev, new_mesh))
    (params, opt_state), _, _ = restore_checkpoint(args.ckpt_dir, template)
    if _rank(new_mesh) == 0:
        print(f"elastic shrink at step {t}: {args.elastic_devices} healthy devices -> mesh "
              f"({d}, {m}){' (single-device lowering)' if new_mesh is None else ''}; "
              f"re-lowered and restored", flush=True)
    return step_fn, params, opt_state, new_mesh


def _rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_rank()


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
    mesh = None
    if mesh_mod.in_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        data, model = plan_shrink(world)
        if data * model != world:
            ap.error(f"torchrun started {world} ranks: no supported mesh has as many "
                     f"(the largest that fits is ({data}, {model}))")
        mesh = mesh_mod.join_mesh(model=model, device=dev)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    say = _rank(mesh) == 0
    cfg, step_fn, pipe = build(args.arch, args.smoke, args.seq, args.batch, args.lr,
                               args.steps, mesh=mesh)
    params, opt_state = _init_state(cfg, args.seed, dev, mesh)
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start, _ = restore_checkpoint(args.ckpt_dir, (params, opt_state))
        if say:
            print(f"resumed from step {start}")

    n_params = sum(p.numel() for p in params.parameters())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if say:
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M batch={args.batch} "
              f"seq={args.seq} device={where}"
              + ("" if mesh is None else f" mesh={tuple(mesh.mesh.shape)}"))

    losses = []
    t0 = time.time()
    for t in range(start, args.steps):
        if args.elastic_shrink_at is not None and t == args.elastic_shrink_at:
            step_fn, params, opt_state, mesh = _elastic_handoff(args, cfg, params, opt_state,
                                                                t, dev, mesh)
            say = _rank(mesh) == 0
        batch = to_batch(cfg, pipe.batch(t), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if say and (t % args.log_every == 0 or t == args.steps - 1):
            print(f"step {t:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (t + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, t + 1, (params, opt_state),
                            extra={"data_step": t + 1})
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, (params, opt_state),
                        extra={"data_step": args.steps})
    if say:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
