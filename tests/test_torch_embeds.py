"""Embedding input, sinusoidal and multimodal rope, and the two configs
that need them (``musicgen_medium``, ``qwen2_vl_72b``), on the CPU
against the JAX package.

The same numpy-seeded inputs and parameters (the reference's initialisation
with its constants perturbed, carried over by ``params_from_jax``) go
through both packages: the position tables, prefill with every cache
tensor, four chained decode steps, the serve CLI's stub frontend
(``_make_batch``) and greedy generation, and the training loss with every
gradient leaf.  Multimodal position ids come as the reference's
``tests/test_models.py::_batch`` makes them (arange on all three axes), as
its serve CLI makes them (zeros), and at random.

Tolerances, max |port - ref| / max |ref|: 1e-5 for the position tables,
``test_model_serving_matches_jax``'s 1e-4 in float32 and 5e-2 in bf16 for
serving, 1e-5 (loss) and 1e-3 (each gradient leaf) for training in float32.
The largest error measured for each is written beside the test.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch.serve import _make_batch as jmake_batch
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import prefill as jprefill
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.serve import _make_batch
from repro_torch.models import (
    cache_from_jax,
    cache_to_numpy,
    decode_step,
    init_params,
    layers,
    params_from_jax,
    prefill,
)
from test_torch_models import TOL, _leaf_ok, _perturbed_params, _rel, _t
from test_torch_train import _assert_train_matches

EMBEDS = ("musicgen_medium", "qwen2_vl_72b")


@pytest.mark.parametrize("offset", [0, 37])
def test_sinusoidal_positions_match_jax(offset):
    for S, d in ((12, 64), (1, 1536)):
        got = layers.sinusoidal_positions(S, d, offset)
        exp = jlayers.sinusoidal_positions(S, d, offset=offset)
        assert got.dtype == torch.float32 and got.shape == (S, d)
        assert _rel(got, exp) < 1e-5                 # <= 3.6e-7


def test_mrope_cos_sin_matches_jax(rng):
    """The SMOKE sections (4, 2, 2) over position ids that differ on each
    axis, and the full config's (16, 24, 24); the rotation of a (B, S, H,
    hd) tensor by the (B, S, hd/2) tables."""
    for sections, hd in (((4, 2, 2), 16), ((16, 24, 24), 128)):
        pos_ids = rng.integers(0, 500, size=(3, 2, 9)).astype(np.int32)
        cj, sj = jlayers.mrope_cos_sin(jnp.asarray(pos_ids), sections, hd, 1e6)
        ct, st = layers.mrope_cos_sin(_t(pos_ids), sections, hd, 1e6)
        assert ct.shape == (2, 9, hd // 2) and ct.dtype == torch.float32
        assert _rel(ct, cj) < 1e-5 and _rel(st, sj) < 1e-5     # <= 4.8e-7
        x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
        assert _rel(layers.apply_rope(_t(x), ct, st),
                    jlayers.apply_rope(jnp.asarray(x), cj, sj)) < 1e-5
    with pytest.raises(ValueError, match="sections"):
        layers.mrope_cos_sin(_t(pos_ids), (4, 2, 1), 16, 1e6)


def _pos_ids(kind, rng, B, S):
    if kind == "arange":         # tests/test_models.py::_batch
        return np.broadcast_to(np.arange(S)[None, None], (3, B, S)).astype(np.int32)
    if kind == "zeros":          # the serve CLI
        return np.zeros((3, B, S), np.int32)
    return rng.integers(0, 2 * S, size=(3, B, S)).astype(np.int32)


def _inputs(cfg, jcfg, toks, pos_ids):
    """(JAX batch, port batch) of stub embeddings (and position ids)."""
    jb = jmake_batch(jcfg, jnp.asarray(toks))
    tb = _make_batch(cfg, _t(toks))
    if cfg.pos == "mrope":
        jb["pos_ids"], tb["pos_ids"] = jnp.asarray(pos_ids), _t(pos_ids)
    return jb, tb


_JAX_STEPS = {}


def _jax_steps(jcfg, S_max):
    """The reference's prefill and decode step, compiled once per config."""
    if (jcfg, S_max) not in _JAX_STEPS:
        _JAX_STEPS[jcfg, S_max] = (
            jax.jit(lambda p, b: jprefill(p, jcfg, b, S_max=S_max)),
            jax.jit(lambda p, c, b, t: jdecode_step(p, jcfg, c, b, t)))
    return _JAX_STEPS[jcfg, S_max]


# musicgen has no position ids; qwen2-vl's come in three forms in float32
@pytest.mark.parametrize("arch,dtype,pos", [
    ("musicgen_medium", "float32", "arange"), ("musicgen_medium", "bfloat16", "arange"),
    ("qwen2_vl_72b", "float32", "arange"), ("qwen2_vl_72b", "float32", "zeros"),
    ("qwen2_vl_72b", "float32", "random"), ("qwen2_vl_72b", "bfloat16", "arange")])
def test_embeds_serving_matches_jax(rng, arch, dtype, pos):
    """Prefill logits and every cache tensor, then four chained decode
    steps (each package on its own cache; every cache tensor also held on
    one step from the same input cache), as
    ``test_model_serving_matches_jax`` holds the token configs.  Random
    position ids differ on the three axes, so each section rotates by its
    own."""
    jcfg = dataclasses.replace(jget_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp, npp = _perturbed_params(jcfg)
    params = params_from_jax(cfg, npp, device="cpu")
    assert params.embed is None and params.lm_head is not None
    B, S, n_dec = 2, 32, 4
    toks = rng.integers(0, cfg.vocab, size=(B, S + n_dec))
    pos_ids = _pos_ids(pos, rng, B, S + n_dec)
    tol = TOL[dtype]
    jb, tb = _inputs(cfg, jcfg, toks[:, :S], pos_ids[..., :S])
    jprefill_fn, dec = _jax_steps(jcfg, S + n_dec)
    jl, jc = jprefill_fn(jp, jb)
    logits, cache = prefill(params, cfg, tb, S_max=S + n_dec)
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab)
    assert _rel(logits, jl) < tol             # f32 <= 6.0e-7, bf16 <= 1.2e-2
    for got, exp in zip(cache_to_numpy(cfg, cache), jc):
        for name in exp:
            assert _leaf_ok(got[name], exp[name], tol), name
    for i in range(n_dec):
        # decode adds the position to the step's ids: relative zeros, or the
        # random ids' own offsets from their position
        step_ids = pos_ids[..., S + i:S + i + 1] - (0 if pos == "zeros" else S + i)
        jbs, tbs = _inputs(cfg, jcfg, toks[:, S + i:S + i + 1], step_ids)
        same_in = cache_from_jax(cfg, jax.tree.map(np.asarray, jc), device="cpu")
        jl, jc = dec(jp, jc, jbs, jnp.int32(S + i))
        logits, cache = decode_step(params, cfg, cache, tbs, S + i)
        assert _rel(logits, jl) < tol, i      # f32 <= 1.4e-6, bf16 <= 2.3e-2
        _, same_out = decode_step(params, cfg, same_in, tbs, S + i)
        for got, exp in zip(cache_to_numpy(cfg, same_out), jc):
            for name in exp:
                assert _leaf_ok(got[name], exp[name], tol), (i, name)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("arch", EMBEDS)
def test_decode_matches_full_forward(arch):
    """The reference's own check (``tests/test_models.py``), on the port's
    parameters: prefill(S) + decode(1) logits == prefill(S + 1)'s last,
    with the reference test's arange position ids (the step's ids relative
    zeros: decode adds the position)."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=2, device="cpu")
    B, S = 2, 64
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=torch.Generator().manual_seed(2))
    full_b = _make_batch(cfg, toks)
    pre_b = _make_batch(cfg, toks[:, :S])
    step_b = _make_batch(cfg, toks[:, S:])
    if cfg.pos == "mrope":
        full_b["pos_ids"] = torch.arange(S + 1, dtype=torch.int32).expand(3, B, S + 1)
        pre_b["pos_ids"] = full_b["pos_ids"][..., :S]
    full, _ = prefill(params, cfg, full_b)
    _, cache = prefill(params, cfg, pre_b, S_max=S + 4)
    dec, _ = decode_step(params, cfg, cache, step_b, S)
    assert _rel(dec, full.numpy()) < 0.05     # musicgen 3.3e-3, qwen2-vl 6.1e-3


def test_make_batch_equals_the_reference_bit_for_bit(rng):
    """The serve CLI's stub frontend, at the SMOKE and the full widths."""
    for arch in EMBEDS + ("qwen3_0_6b",):
        for cfg, jcfg in ((get_smoke_config(arch), jget_smoke_config(arch)),
                          (get_config(arch), jget_config(arch))):
            toks = rng.integers(0, cfg.vocab, size=(3, 40))
            got, exp = _make_batch(cfg, _t(toks)), jmake_batch(jcfg, jnp.asarray(toks))
            assert set(got) == set(exp)
            for name in exp:
                e = np.asarray(exp[name])
                g = got[name]
                if e.dtype.name == "bfloat16":
                    assert g.dtype == torch.bfloat16
                    np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                                  e.view(np.int16))
                else:
                    np.testing.assert_array_equal(g.numpy(), e)


@pytest.mark.parametrize("arch", EMBEDS)
def test_generate_gives_the_reference_greedy_tokens(arch):
    """float32: the reference CLI's loop (its prefill and serve steps on its
    ``_make_batch``, weights from ``init_params(PRNGKey(0))``, prompts from
    ``randint`` of the same key) and the port's ``generate`` on those
    weights and prompts pick the same tokens."""
    jcfg = dataclasses.replace(jget_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    key = jax.random.PRNGKey(0)
    jp = jinit_params(jcfg, key)
    B, S, G = 2, 16, 8
    prompts = jax.random.randint(key, (B, S), 0, jcfg.vocab)
    prefill_fn = jax.jit(jmake_prefill_step(jcfg, None, S_max=S + G))
    serve_fn = jax.jit(jmake_serve_step(jcfg))
    logits, cache = prefill_fn(jp, jmake_batch(jcfg, prompts))
    exp = [jnp.argmax(logits, -1)]
    for i in range(G - 1):
        logits, cache = serve_fn(jp, cache, jmake_batch(jcfg, exp[-1][:, None]), jnp.int32(S + i))
        exp.append(jnp.argmax(logits, -1))
    exp = np.stack([np.asarray(t) for t in exp], 1)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    got, stats = serve.generate(cfg, params, _t(np.asarray(prompts)), G)
    assert stats["decode_steps"] == G - 1
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("arch", EMBEDS)
def test_serve_cli_serves_embeddings_on_the_cpu(capsys, arch):
    tokens = serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "16",
                         "--gen", "4", "--device", "cpu"])
    cfg = get_smoke_config(arch)
    assert tokens.shape == (2, 4) and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
    assert f"arch={cfg.name} batch=2 prompt=16 gen=4 device=cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", EMBEDS)
def test_train_loss_and_grads_match_jax(rng, arch):
    """float32: the loss of stub embeddings (and, for Qwen2-VL, random
    position ids on the three axes) within 1e-5, every gradient leaf,
    ``lm_head`` among them, within 1e-3 of its largest value."""
    _assert_train_matches(rng, arch, False)
