"""A checkpoint written by either package restores in the other.

The port writes ``(LM, AdamW state)`` as the reference writes ``(params,
opt_state)``: the stacked pattern-group leaves in ``jax.tree.leaves`` order,
the reference's manifest keys and shard names.  On SMOKE configs of the
three block families (attention, RWKV, Jamba with its MoE FFNs), in both
directions, every leaf must come back bit for bit; and the port's trainer
resumes from a directory the JAX trainer wrote.
"""
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as jrestore_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train
from repro_torch.models import init_params, params_from_jax
from repro_torch.optim import adamw_init

ARCHS = ("qwen3_0_6b", "rwkv6_3b", "jamba_1_5_large_398b")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (bf16 through int16, so -0.0 and NaNs compare too)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def _assert_named_equal(got: dict, exp: dict, what: str) -> None:
    assert list(got) == list(exp), what
    for name, g in got.items():
        e = exp[name]
        assert g.dtype == e.dtype and g.shape == e.shape, (what, name)
        assert torch.equal(_bits(g.detach()), _bits(e.detach())), (what, name)


def _named(cfg, tree) -> dict:
    """The reference's parameter-shaped tree as the port's name-keyed
    tensors (bit for bit; bf16 goes through float32 exactly)."""
    lm = params_from_jax(cfg, jax.tree.map(np.asarray, tree), device="cpu")
    return {k: v.detach() for k, v in lm.named_parameters()}


def _jax_state(arch: str, seed: int):
    """The reference's (params, AdamW state) with every moment and the step
    made nonzero, so each leaf tells its place."""
    jcfg = jget_smoke_config(arch)
    params = jinit_params(jcfg, jax.random.PRNGKey(seed))
    opt = jadamw_init(params)
    rng = np.random.default_rng(seed)
    for part in ("mu", "nu"):
        opt[part] = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), opt[part])
    opt["step"] = jnp.asarray(7, jnp.int32)
    return params, opt


def _port_state(cfg, seed: int):
    params = init_params(cfg, seed=seed, device="cpu")
    opt = adamw_init(params)
    gen = torch.Generator().manual_seed(seed)
    for part in ("mu", "nu"):
        opt[part] = {k: torch.randn(v.shape, generator=gen) for k, v in opt[part].items()}
    opt["step"] = torch.tensor(5, dtype=torch.int32)
    return params, opt


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    cfg = get_smoke_config(arch)
    jparams, jopt = _jax_state(arch, seed=0)
    jsave_checkpoint(tmp_path, 7, (jparams, jopt), extra={"data_step": 7})
    fresh = init_params(cfg, seed=3, device="cpu")
    (got, got_opt), step, extra = restore_checkpoint(tmp_path, (fresh, adamw_init(fresh)))
    assert got is fresh and step == 7 and extra == {"data_step": 7}
    _assert_named_equal({k: v.detach() for k, v in got.named_parameters()},
                        _named(cfg, jparams), "params")
    for part in ("master", "mu", "nu"):
        _assert_named_equal(got_opt[part], _named(cfg, jopt[part]), part)
    assert got_opt["step"].dtype == torch.int32 and int(got_opt["step"]) == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    cfg = get_smoke_config(arch)
    params, opt = _port_state(cfg, seed=0)
    path = save_checkpoint(tmp_path, 5, (params, opt), extra={"data_step": 5})
    manifest = json.loads((path / "manifest.json").read_text())
    assert sorted(manifest) == ["dtypes", "extra", "index", "n_leaves", "step", "treedef"]
    assert sorted(p.name for p in path.iterdir()) == [".COMMIT", "manifest.json",
                                                      "shard_00000.npz"]
    template = _jax_state(arch, seed=1)
    (jparams, jopt), step, extra = jrestore_checkpoint(tmp_path, template)
    assert step == 5 and extra == {"data_step": 5}
    # the reference restored the same leaves it would have written
    assert jax.tree.structure((jparams, jopt)) == jax.tree.structure(template)
    _assert_named_equal(_named(cfg, jparams),
                        {k: v.detach() for k, v in params.named_parameters()}, "params")
    for part in ("master", "mu", "nu"):
        _assert_named_equal(_named(cfg, jopt[part]), opt[part], part)
    assert np.asarray(jopt["step"]).dtype == np.int32 and int(jopt["step"]) == 5
    # and back: the port's own round trip of the same directory
    fresh = init_params(cfg, seed=2, device="cpu")
    (got, got_opt), _, _ = restore_checkpoint(tmp_path, (fresh, adamw_init(fresh)))
    _assert_named_equal({k: v.detach() for k, v in got.named_parameters()},
                        {k: v.detach() for k, v in params.named_parameters()}, "round trip")


def test_leaf_count_mismatch_names_both_counts(tmp_path):
    jparams, jopt = _jax_state("qwen3_0_6b", seed=0)
    jsave_checkpoint(tmp_path, 1, (jparams, jopt))
    fresh = init_params(get_smoke_config("rwkv6_3b"), seed=0, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, (fresh, adamw_init(fresh)))


def test_port_trainer_resumes_a_jax_trainer_directory(tmp_path, capsys):
    """The JAX trainer runs 4 steps, checkpointing every 2; with its last
    checkpoint gone, the port's ``--resume`` restarts at step 2 from the
    JAX weights and optimizer state and the same data stream: its losses
    are the JAX run's steps 2-3 within the two packages' bf16 agreement."""
    args = ["--arch", "qwen3_0_6b", "--smoke", "--batch", "2", "--seq", "32",
            "--steps", "4", "--log-every", "100", "--ckpt-dir", str(tmp_path)]
    l_jax = jtrain.main(args + ["--ckpt-every", "2"])
    assert latest_step(tmp_path) == 4
    shutil.rmtree(tmp_path / "step_000000004")
    l_port = train.main(args + ["--resume", "--device", "cpu"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(l_port) == 2 and latest_step(tmp_path) == 4
    np.testing.assert_allclose(l_port, l_jax[2:], rtol=1e-2)
