"""The port's LM serving path (on the CPU) against the JAX package's.

The same parameters (the reference's initialisation, with the constants it
starts at zero or one perturbed by seeded numpy noise so the bonus, decay,
step-size and bias terms are exercised) and the same tokens go through both
packages' layers, blocks and whole models.  Where the JAX function reaches a
Pallas kernel it runs in interpret mode, as its own tests run it; the port
runs the kernels' plain versions.

Tolerances, max |port - ref| / max |ref|: 1e-4 in float32 (sums in another
order; the reference's associative scans and the port's step loops agree to
float32 rounding), 5e-2 in the configs' own bfloat16 (bf16 rounds at other
places in the two frameworks), the bound the reference holds its own decode
against its full forward to.  The largest error measured for each is written
beside the test.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import (
    attention,
    cache_from_jax,
    cache_to_numpy,
    decode_step,
    init_params,
    layers,
    mamba,
    moe,
    params_from_jax,
    prefill,
    rwkv6,
)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ("rwkv6_3b", "jamba_1_5_large_398b", "qwen3_0_6b", "qwen2_0_5b",
         "granite_3_8b", "gemma3_12b", "qwen2_moe_a2_7b", "qwen3_moe_235b_a22b")
DENSE = ("qwen3_0_6b", "qwen2_0_5b", "granite_3_8b")   # attention with rope
# rotary attention and no scan: sliding windows (gemma3), MoE FFNs (qwen)
ATTN_ONLY = DENSE + ("gemma3_12b", "qwen2_moe_a2_7b", "qwen3_moe_235b_a22b")
# Jamba's SMOKE served with its MoE FFNs; "jamba_1_5_large_398b" is the
# one-group cut with dense FFNs that chip_smoke.py serves at full width
JAMBA_MOE = "jamba_1_5_large_398b:moe"


def _rel(got, exp) -> float:
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    exp = np.asarray(exp, np.float32)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    return float(np.max(np.abs(got - exp)) / (np.max(np.abs(exp)) + 1e-12))


def _leaf_ok(got, exp, tol, src_tol=0.0) -> bool:
    """A cache leaf within ``tol``.  The shift and conv states are stored in
    bfloat16 whatever the config's dtype (in both packages), so in a float32
    config a difference of 1e-7 in their float32 source can move one value
    by a bfloat16 rounding step: those leaves are held to one step per
    element, |got - exp| <= 2^-7 |exp|, instead.  ``src_tol`` adds how far
    the float32 source may differ, as a share of the leaf's largest value
    (an element near zero, after cancellation, can move by more than one
    step of its own size)."""
    if np.asarray(exp).dtype.name == "bfloat16" and tol < 2.0 ** -7:
        exp = np.asarray(exp, np.float32)
        got = np.asarray(got, np.float32)
        slack = src_tol * float(np.abs(exp).max())
        return bool(np.all(np.abs(got - exp) <= 2.0 ** -7 * np.abs(exp) + slack))
    return _rel(got, exp) < tol


def _t(x):
    """numpy -> CPU tensor (bfloat16 through float32, exactly)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _dense(cfg):
    """Jamba's pattern with every FFN a dense MLP and no MoE config: the
    one-group cut the port serves (the reference runs it as well)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=None,
                               pattern=tuple((m, "mlp") for m, _ in cfg.pattern))


def _configs(case, dtype, kernel):
    """(JAX, port) SMOKE configs of ``case``: an arch id, or JAMBA_MOE."""
    arch = case.removesuffix(":moe")
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    if case == "jamba_1_5_large_398b":
        jcfg, cfg = _dense(jcfg), _dense(cfg)
    kw = dict(dtype=dtype, rwkv_kernel=kernel, mamba_kernel=kernel)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


# leaf name -> scale of the seeded noise added to the reference's init
_PERTURB = {"u": 0.5, "mu": 0.3, "w_decay_base": 1.5, "dt_bias": 1.0, "D": 0.3,
            "conv_b": 0.1, "ln_scale": 0.2, "scale": 0.1}


def _perturbed_params(jcfg, seed=0):
    """The reference's init_params, with the constants perturbed; returns
    (JAX params, the same as numpy arrays)."""
    rng = np.random.default_rng(seed)
    params = jinit_params(jcfg, jax.random.PRNGKey(seed))

    def perturb(path, x):
        name = path[-1].key
        if name not in _PERTURB:
            return x
        noisy = np.asarray(x, np.float32) + _PERTURB[name] * rng.standard_normal(x.shape)
        return jnp.asarray(noisy, x.dtype)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# configs and layers


def test_configs_match_the_reference_field_for_field():
    for arch in ARCHS + ("musicgen_medium", "qwen2_vl_72b"):
        for port_cfg, jax_cfg in ((get_config(arch), jget_config(arch)),
                                  (get_smoke_config(arch), jget_smoke_config(arch))):
            a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)
            assert a == b, arch
            assert port_cfg.n_groups == jax_cfg.n_groups
    assert get_config("rwkv6_3b").param_dtype == torch.bfloat16
    assert get_smoke_config("granite_3_8b").vocab == 515
    assert get_config("gemma3_12b").window == 1024
    assert get_config("qwen3_moe_235b_a22b").moe.n_experts == 128
    # the two embedding-input configs: sinusoidal and multimodal positions
    assert get_config("musicgen_medium").pos == "sinusoidal"
    assert get_smoke_config("qwen2_vl_72b").mrope_sections == (4, 2, 2)
    assert get_config("qwen2_vl_72b").input_mode == "embeds"
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gpt2")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_layers_match_jax(rng, act):
    d, d_ff = 24, 40
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    p = jlayers.init_mlp(jax.random.PRNGKey(1), d, d_ff, act, jnp.float32)
    pn = {k: np.asarray(v) for k, v in p.items()}
    got = layers.apply_mlp({k: _t(v) for k, v in pn.items()}, _t(x), act)
    assert _rel(got, jlayers.apply_mlp(p, jnp.asarray(x), act)) < 1e-5   # 1.2e-7
    scale = rng.normal(size=(d,)).astype(np.float32)
    got = layers.rmsnorm({"scale": _t(scale)}, _t(x))
    assert _rel(got, jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))) < 1e-6
    table = rng.normal(size=(50, d)).astype(np.float32)
    toks = rng.integers(0, 50, size=(2, 5))
    np.testing.assert_array_equal(
        layers.embed({"table": _t(table)}, _t(toks)).numpy(),
        np.asarray(jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))))


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_jax(rng, offset):
    """cos/sin of offset positions (as decode asks) and the rotation, in
    float32, against ``repro.models.layers``; (S, hd/2) and (B, S, hd/2)
    tables."""
    B, S, H, hd, theta = 2, 12, 3, 16, 1e6
    positions = np.arange(S) + offset
    cj, sj = jlayers.rope_cos_sin(jnp.asarray(positions), hd, theta)
    ct, st = layers.rope_cos_sin(torch.as_tensor(positions), hd, theta)
    assert ct.dtype == st.dtype == torch.float32 and ct.shape == (S, hd // 2)
    assert _rel(ct, cj) < 1e-6 and _rel(st, sj) < 1e-6
    np.testing.assert_allclose(layers.rope_freqs(hd, theta).numpy(),
                               np.asarray(jlayers.rope_freqs(hd, theta)), rtol=1e-6)
    x = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    got = layers.apply_rope(_t(x), ct, st)
    assert _rel(got, jlayers.apply_rope(jnp.asarray(x), cj, sj)) < 1e-6
    cb, sb = (np.broadcast_to(np.asarray(a), (B, S, hd // 2)) for a in (cj, sj))
    got = layers.apply_rope(_t(x), _t(cb), _t(sb))
    assert _rel(got, jlayers.apply_rope(jnp.asarray(x), jnp.asarray(cb),
                                        jnp.asarray(sb))) < 1e-6
    xb = _t(x).bfloat16()
    assert layers.apply_rope(xb, ct, st).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# mixers and FFNs, with and without a carried state


def _block_params(arch, position, dtype="float32"):
    """One pattern position's (mixer, ffn) parameters of the SMOKE config,
    perturbed, group 0: (JAX dict, port dict) for each."""
    jcfg, cfg = _configs(arch, dtype, False)
    jp, npp = _perturbed_params(jcfg)
    blk_j = jax.tree.map(lambda a: a[0], jp["blocks"][position])
    blk_n = jax.tree.map(lambda a: a[0], npp["blocks"][position])
    port = {k: {n: _t(v) for n, v in blk_n[k].items()} for k in ("mixer", "ffn")}
    return jcfg, cfg, blk_j, port


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_blocks_match_jax(rng, carried, use_kernel):
    jcfg, cfg, pj, pt = _block_params("rwkv6_3b", 0)
    B, S, d = 2, 24, cfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    H = pt["mixer"]["u"].shape[0]
    hd = cfg.rwkv_head_dim
    state_n = None
    if carried:
        state_n = {"shift_t": np.asarray(jnp.asarray(rng.normal(size=(B, d)), jnp.bfloat16)),
                   "shift_c": np.asarray(jnp.asarray(rng.normal(size=(B, d)), jnp.bfloat16)),
                   "wkv": rng.normal(size=(B, H, hd, hd)).astype(np.float32)}
    sj = None if state_n is None else {k: jnp.asarray(v) for k, v in state_n.items()}
    st = None if state_n is None else {k: _t(v) for k, v in state_n.items()}
    yj, cj = jrwkv.rwkv_tmix_forward(pj["mixer"], jnp.asarray(x), head_dim=hd,
                                     state=sj, return_state=True, use_kernel=use_kernel)
    yt, ct = rwkv6.rwkv_tmix_forward(pt["mixer"], _t(x), head_dim=hd, state=st,
                                     return_state=True, use_kernel=use_kernel)
    assert _rel(yt, yj) < TOL["float32"]                                 # 3.3e-7
    for k in ("shift_t", "wkv"):
        assert ct[k].dtype == (torch.bfloat16 if k == "shift_t" else torch.float32)
        assert _rel(ct[k], cj[k]) < TOL["float32"]                       # 1.8e-7
    yj, cj = jrwkv.rwkv_cmix_forward(pj["ffn"], jnp.asarray(x), state=sj,
                                     return_state=True)
    yt, ct = rwkv6.rwkv_cmix_forward(pt["ffn"], _t(x), state=st, return_state=True)
    assert _rel(yt, yj) < TOL["float32"]                                 # 4.7e-8
    assert _rel(ct["shift_c"], cj["shift_c"]) == 0.0
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_matches_jax(rng, carried, use_kernel):
    jcfg, cfg, pj, pt = _block_params("jamba_1_5_large_398b", 1)
    B, S, d = 2, 20, cfg.d_model
    d_inner = cfg.mamba_expand * d
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    state_n = None
    if carried:
        state_n = {"conv": np.asarray(jnp.asarray(
                       rng.normal(size=(B, cfg.mamba_dconv - 1, d_inner)), jnp.bfloat16)),
                   "ssm": rng.normal(size=(B, d_inner, cfg.mamba_d_state)).astype(np.float32)}
    sj = None if state_n is None else {k: jnp.asarray(v) for k, v in state_n.items()}
    st = None if state_n is None else {k: _t(v) for k, v in state_n.items()}
    yj, cj = jmamba.mamba_forward(pj["mixer"], jnp.asarray(x), state=sj,
                                  return_state=True, use_kernel=use_kernel)
    yt, ct = mamba.mamba_forward(pt["mixer"], _t(x), state=st, return_state=True,
                                 use_kernel=use_kernel)
    assert _rel(yt, yj) < TOL["float32"]                                 # 2.0e-7
    assert ct["conv"].dtype == torch.bfloat16
    for k in ("conv", "ssm"):
        assert _rel(ct[k], cj[k]) < TOL["float32"]                       # 2.0e-7
    if carried:   # one decode step on the state just produced
        x1 = rng.normal(size=(B, 1, d)).astype(np.float32)
        yj, cj2 = jmamba.mamba_decode_step(pj["mixer"], jnp.asarray(x1), cj)
        yt, ct2 = mamba.mamba_decode_step(pt["mixer"], _t(x1), ct)
        assert _rel(yt, yj) < TOL["float32"]
        assert _rel(ct2["ssm"], cj2["ssm"]) < TOL["float32"]
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("qk_norm,qkv_bias", [(False, False), (True, True)])
def test_attention_matches_jax(rng, qk_norm, qkv_bias):
    _attention_case(rng, qk_norm, qkv_bias, rope=False)


@pytest.mark.parametrize("qk_norm,qkv_bias", [(False, False), (True, True)])
def test_rotary_attention_matches_jax(rng, qk_norm, qkv_bias):
    """Prefill and decode with rope: q and k rotated after the qk-norm, the
    cache holding rotated keys, decode rotated at its position."""
    _attention_case(rng, qk_norm, qkv_bias, rope=True)


def _attention_case(rng, qk_norm, qkv_bias, rope):
    B, S, d, H, KH, hd = 2, 40, 32, 4, 2, 8
    p = jattn.init_attn(jax.random.PRNGKey(3), d, H, KH, hd, qk_norm, qkv_bias,
                        jnp.float32)
    p = {k: jnp.asarray(np.asarray(v) + 0.3 * rng.standard_normal(v.shape), v.dtype)
         if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v for k, v in p.items()}
    pt = {k: _t(np.asarray(v)) for k, v in p.items()}
    x = rng.normal(size=(B, S, d)).astype(np.float32)

    def cos_sin(start, n):   # rotation of positions start + [0, n), or none
        if not rope:
            return (None, None), None
        cj = jlayers.rope_cos_sin(jnp.arange(n) + start, hd, 1e4)
        return cj, layers.rope_cos_sin(torch.arange(n) + start, hd, 1e4)

    # q_chunk 16, kv_chunk 8: several q chunks, each over several kv tiles
    csj, cst = cos_sin(0, S)
    yj, (kj, vj) = jattn.attn_forward(p, jnp.asarray(x), csj, q_chunk=16,
                                      kv_chunk=8, return_kv=True)
    yt, (kt, vt) = attention.attn_forward(pt, _t(x), cst, q_chunk=16, kv_chunk=8,
                                          return_kv=True)
    assert _rel(yt, yj) < TOL["float32"]                                 # 3.1e-7
    assert _rel(kt, kj) < TOL["float32"] and _rel(vt, vj) < TOL["float32"]
    # decode at position S - 4 of a cache of S - 2, holding the first S - 4
    S_max, pos = S - 2, S - 4
    ck = np.zeros((B, S_max, KH, hd), np.float32)
    cv = np.zeros((B, S_max, KH, hd), np.float32)
    ck[:, :pos], cv[:, :pos] = np.asarray(kj)[:, :pos], np.asarray(vj)[:, :pos]
    x1 = x[:, pos:pos + 1]
    csj, cst = cos_sin(pos, 1)
    yj, ckj, cvj = jattn.attn_decode_step(p, jnp.asarray(x1), csj,
                                          jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos))
    ckt, cvt = _t(ck), _t(cv)
    yt, ck2, cv2 = attention.attn_decode_step(pt, _t(x1), cst, ckt, cvt, pos)
    assert ck2 is ckt and cv2 is cvt                  # written in place
    assert _rel(yt, yj) < TOL["float32"]                                 # 1.7e-7
    assert _rel(ck2, ckj) < TOL["float32"] and _rel(cv2, cvj) < TOL["float32"]
    # the decode step's output equals the full forward's at that position
    # (the cache holds keys rotated at their own positions)
    csj, _ = cos_sin(0, pos + 1)
    assert _rel(yt[:, 0], np.asarray(
        jattn.attn_forward(p, jnp.asarray(x[:, :pos + 1]), csj))[:, -1]) < 1e-4


# ---------------------------------------------------------------------------
# whole models: prefill, every cache tensor, 4 chained decode steps

_JAX_DECODE = {}


def _jax_decode(jcfg):
    """The reference's decode step compiled once per config (the whole
    config is the key: Jamba's dense cut and its MoE SMOKE share a name)."""
    if jcfg not in _JAX_DECODE:
        _JAX_DECODE[jcfg] = jax.jit(lambda p, c, b, pos: jdecode_step(p, jcfg, c, b, pos))
    return _JAX_DECODE[jcfg]


# Jamba's SMOKE with its MoE FFNs is held in float32 only: in bfloat16 the
# two packages' router inputs differ by bf16 rounding, which moves router
# logits by more than some tokens' top-2 gap at 4 experts, so those tokens
# take another expert (test_bfloat16_routing_flips_only_at_near_ties).
@pytest.mark.parametrize("arch,dtype,kernel", [
    (arch, dtype, kernel) for kernel in (False, True) for dtype in ("float32", "bfloat16")
    for arch in ARCHS + (JAMBA_MOE,)
    if not (kernel and arch in ATTN_ONLY) and (arch, dtype) != (JAMBA_MOE, "bfloat16")])
def test_model_serving_matches_jax(rng, arch, dtype, kernel):
    """(The scan kernels' flags do nothing in the attention-only configs,
    which are served once.)  Gemma's SMOKE window of 16 at S = 32 masks
    the prefill's band and wraps the ring in the decode steps; the MoE
    configs route every token through their top-k experts."""
    jcfg, cfg = _configs(arch, dtype, kernel)
    jp, npp = _perturbed_params(jcfg)
    params = params_from_jax(cfg, npp, device="cpu")
    B, S, n_dec = 2, 32, 4
    toks = rng.integers(0, cfg.vocab, size=(B, S + n_dec))
    tol = TOL[dtype]

    jl, jc = jax.jit(lambda p, b: jprefill(p, jcfg, b, S_max=S + n_dec))(
        jp, {"tokens": jnp.asarray(toks[:, :S])})
    logits, cache = prefill(params, cfg, {"tokens": _t(toks[:, :S])}, S_max=S + n_dec)
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab)
    assert _rel(logits, jl) < tol          # f32 <= 1.7e-6, bf16 <= 2.2e-2
    for got, exp in zip(cache_to_numpy(cfg, cache), jc):
        assert set(got) == set(exp)
        for name in exp:   # f32 <= 3.1e-6 (bf16-stored: one step); bf16 <= 4.0e-2
            assert _leaf_ok(got[name], exp[name], tol), name

    # four chained decode steps.  Each package runs on its own cache and the
    # logits are held at every step.  The stored bf16 conv/shift states can
    # differ by a rounding step (above), which later steps carry into the
    # float32 states (jamba float32: ssm 1.2e-4 after four steps), so every
    # cache tensor is compared on one step from the SAME input cache: the
    # port's step on the reference's cache against the reference's step.
    # Jamba with MoE FFNs, float32, step 3: one conv element of the third
    # layer, -6.06e-5 in a leaf whose largest value is 3.23, moves by two
    # bf16 steps of its size (9.5e-7) while the leaf agrees to 2.9e-7 of its
    # largest value and every MoE layer's output to 1.6e-7: its float32
    # source is a sum of terms near 3 that cancels
    src_tol = 1e-6 if arch == JAMBA_MOE else 0.0
    dec = _jax_decode(jcfg)
    for i in range(n_dec):
        step = toks[:, S + i:S + i + 1]
        same_in = cache_from_jax(cfg, jax.tree.map(np.asarray, jc), device="cpu")
        jl, jc = dec(jp, jc, {"tokens": jnp.asarray(step)}, jnp.int32(S + i))
        logits, cache = decode_step(params, cfg, cache, {"tokens": _t(step)}, S + i)
        assert _rel(logits, jl) < tol, i   # f32 <= 5.1e-5, bf16 <= 3.2e-2
        _, same_out = decode_step(params, cfg, same_in, {"tokens": _t(step)}, S + i)
        for got, exp in zip(cache_to_numpy(cfg, same_out), jc):
            for name in exp:   # f32 <= 1.3e-6 (bf16-stored: one step); bf16 <= 2.2e-2
                assert _leaf_ok(got[name], exp[name], tol, src_tol), (i, name)
    assert not any(ops.launch_counts().values())


def test_bfloat16_routing_flips_only_at_near_ties(rng, monkeypatch):
    """Jamba's SMOKE with MoE FFNs in bfloat16, prefill: the tokens the two
    packages route to different experts are each explained.  At every MoE
    layer, a token that routed alike at the layers before ("clean") and
    whose reference top-k gap in router logits exceeds twice the largest
    router-logit difference among clean tokens must take the same experts;
    the others are counted and printed, with the last logits' distance
    (a flipped token's expert changes its FFN output outright, so the
    logits may move by more than the bf16 TOL: 6.7e-2 here)."""
    jcfg, cfg = _configs(JAMBA_MOE, "bfloat16", False)
    jp, npp = _perturbed_params(jcfg)
    params = params_from_jax(cfg, npp, device="cpu")
    S, k = 32, cfg.moe.top_k
    toks = rng.integers(0, cfg.vocab, size=(2, S))
    seen_j, seen_t = [], []
    route_j, route_t = jmoe._route, moe._route

    def record_j(w, x, c):
        out = route_j(w, x, c)
        jax.debug.callback(lambda e, lg: seen_j.append((np.asarray(e), np.asarray(lg))),
                           out[1], x.astype(jnp.float32) @ w)
        return out

    def record_t(w, x, c):
        out = route_t(w, x, c)
        seen_t.append((out[1].numpy(), (x.float() @ w).numpy()))
        return out

    monkeypatch.setattr(jmoe, "_route", record_j)
    monkeypatch.setattr(moe, "_route", record_t)
    jl, _ = jax.jit(lambda p, b: jprefill(p, jcfg, b))(jp, {"tokens": jnp.asarray(toks)})
    logits, _ = prefill(params, cfg, {"tokens": _t(toks)})
    assert len(seen_j) == len(seen_t) == cfg.n_layers // 2
    clean = np.ones(toks.size, bool)
    flips = []
    for layer, ((ej, lj), (et, lt)) in enumerate(zip(seen_j, seen_t)):
        same = (np.sort(ej, -1) == np.sort(et, -1)).all(-1)
        noise = float(np.abs(lj - lt)[clean].max())
        top = -np.sort(-lj, -1)
        gap = top[:, k - 1] - top[:, k]
        assert same[clean & (gap > 2 * noise)].all(), layer
        flips.append(int((~same).sum()))
        clean &= same
    print(f"jamba MoE bf16 prefill: tokens routed differently per MoE layer {flips} "
          f"of {toks.size}; last logits rel {_rel(logits, jl):.3e}")
    assert np.isfinite(np.asarray(jl)).all() and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS + (JAMBA_MOE,))
def test_params_from_jax_is_bit_exact(arch):
    jcfg, cfg = _configs(arch, "bfloat16", False)
    _, npp = _perturbed_params(jcfg, seed=1)
    params = params_from_jax(cfg, npp, device="cpu")
    P = len(cfg.pattern)
    n_leaves = 0
    for p, pos in enumerate(npp["blocks"]):
        for part, leaves in pos.items():
            for name, leaf in leaves.items():
                assert leaf.shape[0] == cfg.n_groups
                for g in range(cfg.n_groups):
                    got = getattr(params.blocks[g * P + p], part)[name]
                    assert got.dtype == getattr(torch, leaf.dtype.name)
                    np.testing.assert_array_equal(got.float().numpy(),
                                                  leaf[g].astype(np.float32))
                    n_leaves += 1
    tops = [top for top in ("embed", "lm_head", "final_norm") if top in npp]
    assert ("lm_head" in npp) == (not cfg.tie_embeddings)
    for top in tops:
        for name, leaf in npp[top].items():
            np.testing.assert_array_equal(
                getattr(params, top)[name].float().numpy(), leaf.astype(np.float32))
            n_leaves += 1
    n_jax = sum(leaf.shape[0] if leaf.ndim and len(leaf) == cfg.n_groups else 1
                for leaf in jax.tree.leaves(npp["blocks"])) \
        + len(jax.tree.leaves({k: npp[k] for k in tops}))
    assert n_leaves == n_jax == len(list(params.parameters()))
    # the port's own initialisation has the same layout
    own = init_params(cfg, device="cpu")
    assert [(n, t.shape, t.dtype) for n, t in own.named_parameters()] \
        == [(n, t.shape, t.dtype) for n, t in params.named_parameters()]


def test_decode_matches_full_forward_in_the_port(rng):
    """prefill(S) + decode(1) == prefill(S + 1)'s last logits, the
    reference's own check, on the port's own parameters."""
    for arch in ARCHS + (JAMBA_MOE,):
        _, cfg = _configs(arch, "bfloat16", True)
        params = init_params(cfg, seed=2, device="cpu")
        toks = _t(rng.integers(0, cfg.vocab, size=(2, 41)))
        full, _ = prefill(params, cfg, {"tokens": toks})
        _, cache = prefill(params, cfg, {"tokens": toks[:, :40]}, S_max=44)
        dec, _ = decode_step(params, cfg, cache, {"tokens": toks[:, 40:]}, 40)
        assert _rel(dec, full.numpy()) < 5e-2, arch     # rwkv 0.0, jamba 2.1e-2


# the reference's TestSmoke::test_forward_shapes and test_decode_matches_full_forward
# (tests/test_models.py), on the port's own parameters, for the rope configs
SMOKE_B, SMOKE_S = 2, 64


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_shapes(arch):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (SMOKE_B, SMOKE_S), generator=gen)
    logits, cache = prefill(params, cfg, {"tokens": toks})
    assert logits.shape == (SMOKE_B, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert len(cache) == cfg.n_layers
    assert cache[0]["k"].shape == (SMOKE_B, SMOKE_S, cfg.n_kv_heads, cfg.d_head)


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_decode_matches_full_forward(arch):
    """prefill(S) + decode(1) logits == full forward logits at position S."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (SMOKE_B, SMOKE_S + 1), generator=gen)
    full, _ = prefill(params, cfg, {"tokens": toks})
    _, cache = prefill(params, cfg, {"tokens": toks[:, :SMOKE_S]}, S_max=SMOKE_S + 4)
    dec, _ = decode_step(params, cfg, cache, {"tokens": toks[:, SMOKE_S:]}, SMOKE_S)
    assert _rel(dec, full.numpy()) < 0.05, f"{arch}: decode diverges from full forward"


def test_unported_parts_raise_naming_the_roadmap():
    """Nothing of the LM substrate is unported since sharding landed
    (ROADMAP.md item 8.6): no refusal names the item any more.
    ``apply_moe`` has the reference's signature (the expert-parallel path is
    chosen by the active sharding rules, as in the reference, not by an
    argument) and the trainer's ``build`` given a mesh builds a step under
    the reference's rules; an unknown block kind still raises."""
    cfg = get_smoke_config("qwen2_moe_a2_7b")
    params = init_params(cfg, device="cpu")
    x = torch.zeros((1, 4, cfg.d_model), dtype=cfg.param_dtype)
    with pytest.raises(TypeError):
        moe.apply_moe(params.blocks[0].ffn, x, cfg.moe, rules=object())
    y, aux = moe.apply_moe(params.blocks[0].ffn, x, cfg.moe)       # no rules: dense
    assert y.shape == x.shape and aux.dtype == torch.float32
    for module in (moe, train):
        assert "item 8.6" not in inspect.getsource(module)
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model")})()
    cfg_m, step_m, _ = train.build("qwen3_0_6b", True, 32, 2, 1e-3, 4, mesh=mesh)
    assert cfg_m == get_smoke_config("qwen3_0_6b") and callable(step_m)
    cfg_t, step_fn, pipe = train.build("qwen3_0_6b", True, 32, 2, 1e-3, 4)
    assert cfg_t == get_smoke_config("qwen3_0_6b") and callable(step_fn)
    assert pipe.batch(0)["tokens"].shape == (2, 32)
    with pytest.raises(ValueError, match="unknown block"):
        init_params(dataclasses.replace(cfg, pattern=(("conv", "mlp"),)), device="cpu")


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("rwkv6_3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "rwkv6_3b", "--smoke"])


def test_serve_cli_runs_on_the_cpu(capsys):
    tokens = serve.main(["--arch", "rwkv6_3b", "--smoke", "--batch", "2",
                         "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert tokens.shape == (2, 3) and tokens.dtype == torch.int64
    out = capsys.readouterr().out
    assert "arch=rwkv6-smoke batch=2 prompt=8 gen=3 device=cpu" in out
    cfg = dataclasses.replace(_dense(get_smoke_config("jamba_1_5_large_398b")),
                              mamba_kernel=True)
    params = init_params(cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8))
    toks, stats = serve.generate(cfg, params, prompts, 4)
    assert toks.shape == (2, 4) and stats["decode_steps"] == 3
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("arch", ["gemma3_12b", "qwen2_moe_a2_7b", "qwen3_moe_235b_a22b",
                                  "jamba_1_5_large_398b"])
def test_serve_cli_serves_windows_and_experts_on_the_cpu(capsys, arch):
    """The CLI on the SMOKE configs with sliding windows (a 24-token prompt
    against gemma3's window of 16: the ring wraps while decoding) and MoE
    FFNs (Jamba's SMOKE with its experts)."""
    tokens = serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "24",
                         "--gen", "6", "--device", "cpu"])
    cfg = get_smoke_config(arch)
    assert tokens.shape == (2, 6) and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
    assert f"arch={cfg.name} batch=2 prompt=24 gen=6 device=cpu" in capsys.readouterr().out
    assert not any(ops.launch_counts().values())
