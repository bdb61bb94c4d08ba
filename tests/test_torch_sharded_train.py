"""One sharded train step of the port against the JAX package's
single-device step: SMOKE Qwen3 (``tp_pad=4``, float32) on a (2, 4) mesh of
gloo CPU ranks, the reference's ``TestShardedTraining`` recipe.

The parent runs the reference's ``make_train_step`` without rules on the
JAX parameters and a batch drawn from the seed; every rank loads the same
parameters (``params_from_jax``), shards them and the AdamW state by the
reference's rules (``param_sharding.shard_params``) and runs
``make_train_step(cfg, opt_cfg, rules)``.  The bounds are the reference
test's: the loss within 1e-4 relative, every parameter within 1e-2; the
gradient norm (a global check of the gradients, which one step's
parameters cannot see at lr 3e-4) within 1e-4 relative.  RWKV-6 and Jamba
(through the plain scans, and Jamba's MoE through the expert-parallel
path) run in ``test_torch_sharded_train_{rwkv,jamba}.py``, each file one
spawn with a deadline.
"""
import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import OptConfig

SPAWN_TIMEOUT_S = 150
BATCH, SEQ = 8, 64
LOSS_TOL, PARAM_TOL = 1e-4, 1e-2


def sharded_config(arch: str, **kw):
    """The reference test's config: SMOKE, ``tp_pad=4``, float32."""
    return dataclasses.replace(get_smoke_config(arch), tp_pad=4, dtype="float32", **kw)


def opt_config() -> OptConfig:
    return OptConfig(warmup_steps=1)


def reference_inputs(arch: str, cfg, seq: int = SEQ):
    """(the reference's config, its parameters and a batch of ``BATCH`` x
    ``seq`` tokens drawn from the seed), for ``cfg`` (the SMOKE config of
    ``arch`` with the fields the port's test changed)."""
    import jax

    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.models import init_params as jinit_params
    jcfg = dataclasses.replace(jget_smoke_config(arch), tp_pad=cfg.tp_pad, dtype=cfg.dtype,
                               aux_coef=cfg.aux_coef)
    key = jax.random.PRNGKey(0)
    batch = {"tokens": jax.random.randint(key, (BATCH, seq), 0, jcfg.vocab),
             "labels": jax.random.randint(jax.random.PRNGKey(1), (BATCH, seq), 0, jcfg.vocab)}
    return jcfg, jinit_params(jcfg, key), batch


def reference_step(jcfg, params, batch):
    """The JAX single-device step's loss, gradient norm and new parameters
    (numpy)."""
    import jax

    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.optim import OptConfig as JOptConfig
    from repro.optim import adamw_init as jadamw_init
    jocfg = JOptConfig(**dataclasses.asdict(opt_config()))
    new, _, metrics = jax.jit(jmake_train_step(jcfg, jocfg, None))(
        params, jadamw_init(params), batch)
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            jax.tree.map(np.asarray, new))


def sharded_rank(mesh, cfg, arrays_path):
    """One step on this rank's shards; rank 0 hands back the loss, the
    gradient norm and the whole new parameters.  The parameters and the
    batch come in a file (arguments of a spawn travel slowly: half a MB
    took 20 s to reach eight ranks)."""
    from repro_torch.distributed.param_sharding import shard_params
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import params_from_jax
    from repro_torch.optim import adamw_init
    with open(arrays_path, "rb") as f:
        params_np, batch_np = pickle.load(f)
    rules = default_rules(mesh)
    params = shard_params(params_from_jax(cfg, params_np, device="cpu"), rules)
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch_np.items()}
    params, opt, metrics = make_train_step(cfg, opt_config(), rules)(params, opt, batch)
    new = {n: p.full_tensor().detach() for n, p in params.named_parameters()}
    if mesh.get_rank() != 0:
        return None
    return float(metrics["loss"]), float(metrics["grad_norm"]), new


def run_and_compare(arch: str, tmp_path, seq: int = SEQ, **kw):
    """The parent's single-device JAX step against rank 0 of a (2, 4) mesh,
    on a batch of ``BATCH`` x ``seq`` tokens.  The JAX step (mostly its
    compile) runs in a thread while the ranks run."""
    import jax

    from repro_torch.models import params_from_jax
    cfg = sharded_config(arch, **kw)
    jcfg, params, batch = reference_inputs(arch, cfg, seq)
    path = tmp_path / "arrays.pkl"
    path.write_bytes(pickle.dumps(jax.tree.map(np.asarray, (params, batch))))
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference_step, jcfg, params, batch)
        outs = mesh_mod.spawn_mesh(sharded_rank, data=2, model=4, device="cpu",
                                   args=(cfg, str(path)), timeout_s=SPAWN_TIMEOUT_S)
        loss, gnorm, new_np = ref.result()
    got_loss, got_gnorm, got = outs[0].result
    assert np.isfinite(got_loss)
    assert abs(got_loss - loss) / abs(loss) < LOSS_TOL, (got_loss, loss)
    assert abs(got_gnorm - gnorm) / abs(gnorm) < LOSS_TOL, (got_gnorm, gnorm)
    exp = {n: p.detach() for n, p in params_from_jax(cfg, new_np, device="cpu")
           .named_parameters()}
    worst = max((float((got[n] - exp[n]).abs().max()), n) for n in exp)
    assert worst[0] < PARAM_TOL, worst
    return outs


def test_qwen3_sharded_step_matches_the_jax_single_device_step(tmp_path):
    outs = run_and_compare("qwen3_0_6b", tmp_path)
    assert not any(v for o in outs for v in o.launches.values())
