"""The port's training path (on the CPU) against the JAX package's.

The same numpy-seeded inputs and the same parameters (the reference's
initialisation with its constants perturbed, carried over bit for bit by
``params_from_jax``) go through both packages: the chunked cross entropy,
the two scans' custom backward passes (``WkvFused``, ``MambaScanFused``)
and ``train_loss`` with every gradient leaf (for RWKV and Granite here;
the other SMOKE configs in ``test_torch_train_models.py`` and
``test_torch_embeds.py``).
Where the JAX function reaches a Pallas kernel (the scans' forwards) it
runs in interpret mode, as its own tests run it; the port runs the
kernels' plain versions.  Gradients come back to the reference's tree with
``grads_to_numpy``.

Tolerances, max |port - ref| / max |ref|: 1e-6 for the loss function
alone, the reference's own custom-VJP bar 1e-4 for the scans'
gradients (``tests/test_kernels.py``), 1e-5 for a whole model's loss and
1e-3 for each gradient leaf in float32, 2e-2 for the loss in bf16.  The
largest error measured for each is written beside the test.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import layers as jlayers
from repro.models import train_loss as jtrain_loss
from repro.models.mamba import mamba_scan_fused
from repro.models.rwkv6 import wkv_fused
from repro.models.stats import param_counts as jparam_counts
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.models import grads_to_numpy, init_params, param_shapes, params_from_jax
from repro_torch.models import layers, train_loss
from repro_torch.models.mamba import MambaScanFused
from repro_torch.models.rwkv6 import WkvFused
from repro_torch.models.stats import model_flops, param_counts
from test_torch_models import _perturbed_params, _rel, _t

ARCHS = ("rwkv6_3b", "jamba_1_5_large_398b", "qwen3_0_6b", "qwen2_0_5b", "granite_3_8b",
         "gemma3_12b", "qwen2_moe_a2_7b", "qwen3_moe_235b_a22b", "musicgen_medium",
         "qwen2_vl_72b")
DENSE = ("qwen3_0_6b", "qwen2_0_5b", "granite_3_8b")


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
def test_chunked_ce_loss_matches_jax(rng, z_loss):
    """Value and gradients (x and the table) in float32, four chunks."""
    B, S, d, V = 2, 64, 24, 50
    table = rng.normal(size=(V, d)).astype(np.float32)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)

    def jloss(t, xx):
        return jlayers.chunked_ce_loss(t, xx, jnp.asarray(labels), chunk=16, z_loss=z_loss)

    jl, (jgt, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                                jnp.asarray(x))
    tt, xt = _t(table).requires_grad_(), _t(x).requires_grad_()
    loss = layers.chunked_ce_loss(tt, xt, _t(labels), chunk=16, z_loss=z_loss)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - float(jl)) / abs(float(jl)) < 1e-6     # 0.0
    assert _rel(tt.grad, jgt) < 1e-6 and _rel(xt.grad, jgx) < 1e-6   # 1.3e-7, 1.1e-7
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        layers.chunked_ce_loss(tt, xt[:, :40], _t(labels[:, :40]), chunk=16)


# ---------------------------------------------------------------------------
# the scans' custom backward passes


def _wkv_inputs(rng, B, S, H, dk, dv):
    w = np.exp(-np.exp(rng.normal(-1.0, 1.5, (B, S, H, dk)))).astype(np.float32)
    k, r = (rng.normal(size=(B, S, H, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    u = rng.normal(size=(H, dk)).astype(np.float32)
    return w, k, v, r, u


def _grads(fn, inputs, y_bar, fin_bar):
    """Gradients of sum(y * y_bar) + sum(fin * fin_bar) through ``fn``."""
    ts = [_t(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    y, fin = out[0], out[1]
    (torch.sum(y * _t(y_bar)) + torch.sum(fin * _t(fin_bar))).backward()
    return [t.grad for t in ts]


def _jax_grads(fn, inputs, y_bar, fin_bars):
    """The reference's gradients for each final-state cotangent of
    ``fin_bars``, compiled once."""
    def loss(a, fb):
        y, fin = fn(*a)
        return jnp.sum(y * y_bar) + jnp.sum(fin * fb)
    grad = jax.jit(jax.grad(loss))
    args = tuple(map(jnp.asarray, inputs))
    return [grad(args, jnp.asarray(fb)) for fb in fin_bars]


@pytest.mark.parametrize("S", [128, 40])
def test_wkv_fused_gradients_match(rng, S):
    """WkvFused (the plain forward here, the custom backward) against the
    reference's custom VJP (``wkv_fused``, its Pallas forward in interpret
    mode) and against autograd through the plain WKV (``ref.wkv_scan_ref``),
    at two chunks of 64 steps and at S = 40 (chunks of 8: the kernel's
    64 halved until it divides S); dv != dk; the final state's cotangent is
    random, then absent (None in training, zeros here)."""
    B, H, dk, dv = 2, 3, 16, 8
    inputs = _wkv_inputs(rng, B, S, H, dk, dv)
    y_bar = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    fin_bar = rng.normal(size=(B, H, dk, dv)).astype(np.float32)
    exp_j, exp_unused = _jax_grads(wkv_fused, inputs, y_bar, (fin_bar, 0 * fin_bar))
    got = _grads(WkvFused.apply, inputs, y_bar, fin_bar)
    exp_t = _grads(ref.wkv_scan_ref, inputs, y_bar, fin_bar)
    for name, g, ej, et in zip("wkvru", got, exp_j, exp_t):
        assert _rel(g, ej) < 1e-4, name           # <= 4.6e-7
        assert _rel(g, et.numpy()) < 1e-4, name   # <= 2.3e-7
    # in training the final state is unused: its cotangent is None
    ts = [_t(a).requires_grad_() for a in inputs]
    y, _ = WkvFused.apply(*ts)
    torch.sum(y * _t(y_bar)).backward()
    for name, t, e in zip("wkvru", ts, exp_unused):
        assert _rel(t.grad, e) < 1e-4, name
    assert not any(ops.launch_counts().values())


def _mamba_inputs(rng, B, S, d, s):
    dt = np.log1p(np.exp(rng.normal(-2.0, 1.0, (B, S, d)))).astype(np.float32)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, s)).astype(np.float32) for _ in range(2))
    A_log = (np.log(np.tile(np.arange(1, s + 1, dtype=np.float32), (d, 1)))
             + rng.normal(0, 0.1, (d, s))).astype(np.float32)
    D = rng.normal(size=(d,)).astype(np.float32)
    return dt, x, Bm, Cm, A_log, D


@pytest.mark.parametrize("S", [256, 96])
def test_mamba_scan_fused_gradients_match(rng, S):
    """MambaScanFused against the reference's custom VJP
    (``mamba_scan_fused``) and autograd through the plain scan
    (``ref.mamba_scan_ref``): two chunks of 128 steps, and S = 96 (one
    chunk of 96)."""
    B, d, s = 2, 32, 16
    inputs = _mamba_inputs(rng, B, S, d, s)
    y_bar = rng.normal(size=(B, S, d)).astype(np.float32)
    fin_bar = rng.normal(size=(B, d, s)).astype(np.float32)
    got = _grads(MambaScanFused.apply, inputs, y_bar, fin_bar)
    exp_j, = _jax_grads(mamba_scan_fused, inputs, y_bar, (fin_bar,))
    exp_t = _grads(ref.mamba_scan_ref, inputs, y_bar, fin_bar)
    for name, g, ej, et in zip(("dt", "x", "Bm", "Cm", "A_log", "D"), got, exp_j, exp_t):
        assert _rel(g, ej) < 1e-4, name           # <= 6.8e-7
        assert _rel(g, et.numpy()) < 1e-4, name   # <= 5.3e-7
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# whole models: the loss and every gradient leaf


def _batch(cfg, toks, pos_ids):
    """(JAX batch, port batch): tokens, or the stub embeddings of
    ``tests/test_models.py::_batch`` (+ pos_ids), and labels."""
    if cfg.input_mode == "tokens":
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    else:
        base = np.arange(cfg.d_model, dtype=np.float32)
        emb = np.asarray(jnp.asarray(
            np.sin(toks[..., None].astype(np.float32) * 0.01 + base * 0.1) * 0.1,
            jnp.bfloat16))
        jb, tb = {"embeds": jnp.asarray(emb)}, {"embeds": _t(emb)}
        if cfg.pos == "mrope":
            jb["pos_ids"], tb["pos_ids"] = jnp.asarray(pos_ids), _t(pos_ids)
    jb["labels"], tb["labels"] = jnp.asarray(toks), _t(toks)
    return jb, tb


def _train_case(rng, arch, dtype, kernel):
    kw = dict(dtype=dtype, rwkv_kernel=kernel, mamba_kernel=kernel)
    jcfg = dataclasses.replace(jget_smoke_config(arch), **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    jp, npp = _perturbed_params(jcfg)
    params = params_from_jax(cfg, npp, device="cpu")
    B, S = 2, 32
    toks = rng.integers(0, cfg.vocab, size=(B, S))
    pos_ids = rng.integers(0, 3 * S, size=(3, B, S)).astype(np.int32)
    jb, tb = _batch(cfg, toks, pos_ids)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jtrain_loss(p, jcfg, jb)))(jp)
    params.requires_grad_(True)
    loss = train_loss(params, cfg, tb)
    loss.backward()
    return cfg, float(jl), loss, jax.tree.map(np.asarray, jg), grads_to_numpy(cfg, params)


def _assert_train_matches(rng, arch, kernel):
    """float32, the SMOKE config as published (Jamba with its MoE FFNs, the
    MoE aux loss included); sequence 32 with the loss in one chunk or two;
    with remat, as the configs ask: the loss within 1e-5 and every gradient
    leaf within 1e-3 of its largest value."""
    cfg, jl, loss, jg, got = _train_case(rng, arch, "float32", kernel)
    assert cfg.remat and loss.dtype == torch.float32
    assert abs(loss.item() - jl) / abs(jl) < 1e-5             # <= 1.0e-7
    assert set(got) == set(jg) and len(got["blocks"]) == len(jg["blocks"])
    exp_leaves = jax.tree_util.tree_leaves_with_path(jg)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in exp_leaves]
    for (path, g), (_, e) in zip(got_leaves, exp_leaves):
        assert g.shape == e.shape, path
        assert _rel(g, e) < 1e-3, jax.tree_util.keystr(path)   # <= 1.5e-5
    assert sum(float(np.square(g).sum()) for _, g in got_leaves) > 0
    assert not any(ops.launch_counts().values())


# RWKV through the kernel's path (WkvFused, the chip's train path) and
# through autograd of the plain scan; the other configs split with
# test_torch_train_models.py and test_torch_embeds.py (each file's run
# kept under a minute)
@pytest.mark.parametrize("arch,kernel", [("rwkv6_3b", True), ("rwkv6_3b", False),
                                         ("granite_3_8b", False)])
def test_train_loss_and_grads_match_jax(rng, arch, kernel):
    _assert_train_matches(rng, arch, kernel)


@pytest.mark.parametrize("arch", DENSE)
def test_bfloat16_train_loss_matches_jax(rng, arch):
    """The configs' own bf16: the loss within 2e-2 (bf16 rounds at other
    places in the two frameworks); every gradient leaf finite and, like
    the parameters, bf16 in both."""
    cfg, jl, loss, jg, got = _train_case(rng, arch, "bfloat16", False)
    assert abs(loss.item() - jl) / abs(jl) < 2e-2             # <= 3.5e-5
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(got))
    assert jax.tree.leaves(jg)[0].dtype.name == "bfloat16"


def test_remat_choices_agree(rng):
    """remat off, per group, and per group saving the matrix products
    ("dots", a selective-checkpoint policy) give the same loss and
    gradients: recomputation repeats the same arithmetic."""
    base = dataclasses.replace(get_smoke_config("jamba_1_5_large_398b"), dtype="float32",
                               mamba_kernel=True)
    params = init_params(base, seed=3, device="cpu")
    toks = _t(rng.integers(0, base.vocab, size=(2, 32)))
    out = []
    for remat, policy in ((False, "none"), (True, "none"), (True, "dots")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        params.zero_grad(set_to_none=True)
        params.requires_grad_(True)
        loss = train_loss(params, cfg, {"tokens": toks, "labels": toks})
        loss.backward()
        out.append((loss.item(), [p.grad.clone() for p in params.parameters()]))
    for loss, grads in out[1:]:
        assert loss == out[0][0]
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))


# ---------------------------------------------------------------------------
# parameter counts and FLOPs


def test_param_counts_match_the_reference():
    """All ten full configs, on the meta device (nothing allocated):
    total, embedding, non-embedding and active counts equal the
    reference's exactly, and so do the train FLOPs."""
    assert sorted(list_archs()) == sorted(ARCHS)
    for arch in ARCHS:
        cfg = get_config(arch)
        assert param_counts(cfg) == jparam_counts(jget_config(arch)), arch
        shapes = param_shapes(cfg)
        assert all(t.device.type == "meta" for t in jax.tree.leaves(
            shapes, is_leaf=lambda t: isinstance(t, torch.Tensor)))
        assert model_flops(cfg, "train", 4, 1024) == 6.0 * param_counts(cfg)["active"] * 4096
    assert param_counts(get_config("rwkv6_3b"))["total"] == 3284126208
    assert param_counts(get_config("musicgen_medium"))["total"] == 1362249216
    assert param_counts(get_config("qwen2_vl_72b"))["total"] == 71460495360
