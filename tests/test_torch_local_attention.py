"""Sliding-window attention of the port (on the CPU) against the JAX package's.

The same numpy inputs, from seeds, go through ``repro.models.attention`` and
``repro_torch.models.attention``: the chunked prefill with a window (the
band starting past key 0, ``kv_start > 0``, in most cases), the ring cache's
priming (``lm._prime_ring``) and the ring decode for three windows' worth
of steps past its wrap.  Tolerances are ``tests/test_torch_models.py``'s
``TOL``: 1e-4 in float32, 5e-2 in bfloat16, as max |port - ref| / max |ref|.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import layers as jlayers
from repro_torch.models import attention, layers
from repro_torch.models import lm

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's functions compiled (eager JAX dispatches op by op)
_STATIC = ("window", "q_chunk", "kv_chunk", "return_kv")
j_mha = jax.jit(jattn.mha_chunked, static_argnames=_STATIC[:3])
j_forward = jax.jit(jattn.attn_forward, static_argnames=_STATIC)
j_decode = jax.jit(jattn.attn_decode_step, static_argnames="window")


def _rel(got, exp) -> float:
    got = got.float().numpy()
    exp = np.asarray(exp, np.float32)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    return float(np.max(np.abs(got - exp)) / (np.max(np.abs(exp)) + 1e-12))


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype`` (bf16
    rounded once, by JAX, then carried across exactly through float32)."""
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])


def _attn_params(rng, d, H, KH, hd, qkv_bias, dtype):
    """GQA parameters with qk-norm from numpy (the reference's init_attn
    layout and scales; the biases and norm scales perturbed): (JAX dict,
    port dict)."""
    shapes = {"wq": (d, H, hd), "wk": (d, KH, hd), "wv": (d, KH, hd), "wo": (H, hd, d)}
    if qkv_bias:
        shapes |= {"bq": (H, hd), "bk": (KH, hd), "bv": (KH, hd)}
    jp, tp = {}, {}
    for name, shape in shapes.items():
        scale = 1 / math.sqrt(H * hd) if name == "wo" else (0.3 if name[0] == "b" else
                                                            1 / math.sqrt(d))
        jp[name], tp[name] = _pair(scale * rng.standard_normal(shape), dtype)
    for name in ("q_norm", "k_norm"):     # float32 in both packages
        jp[name], tp[name] = _pair(1 + 0.3 * rng.standard_normal(hd), "float32")
    return jp, tp


def _banded(q, k, v, window):
    """Dense float64 attention under the causal band, GQA by repetition:
    the definition the chunked schedule must meet."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k, v = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    qpos, kpos = np.arange(S)[:, None], np.arange(S)[None, :]
    s = np.where((qpos >= kpos) & (qpos - kpos < window), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(4, 8), (8, 32), (16, 8)])
@pytest.mark.parametrize("window", [5, 12, 24])
def test_windowed_mha_chunked_matches_jax(window, q_chunk, kv_chunk, dtype):
    """Several q chunks, each over one or more kv tiles counted from its
    band's start, which lies past key 0 for the last chunk in every case
    but window 24 with q chunks of 8 and 16."""
    rng = np.random.default_rng(window * 100 + q_chunk * 10 + kv_chunk)
    B, S, H, KH, hd = 2, 32, 4, 2, 8
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (H, KH, KH))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    exp = j_mha(qj, kj, vj, **kw)
    got = attention.mha_chunked(qt, kt, vt, **kw)
    assert got.dtype == TDT[dtype]
    assert _rel(got, exp) < TOL[dtype]                 # f32 <= 4.8e-7, bf16 <= 7.8e-3
    if dtype == "float32":
        assert _rel(got, _banded(q, k, v, window)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_attn_forward_matches_jax(dtype):
    """The whole prefill block with a window: qk-norm, QKV bias, rope."""
    rng = np.random.default_rng(5)
    B, S, d, H, KH, hd = 2, 24, 32, 4, 2, 8
    p, pt = _attn_params(rng, d, H, KH, hd, True, dtype)
    xj, xt = _pair(rng.normal(size=(B, S, d)), dtype)
    csj = jlayers.rope_cos_sin(jnp.arange(S), hd, 1e4)
    cst = layers.rope_cos_sin(torch.arange(S), hd, 1e4)
    yj, (kj, vj) = j_forward(p, xj, csj, window=6, q_chunk=8, kv_chunk=8,
                                      return_kv=True)
    yt, (kt, vt) = attention.attn_forward(pt, xt, cst, window=6, q_chunk=8, kv_chunk=8,
                                          return_kv=True)
    assert _rel(yt, yj) < TOL[dtype]                   # f32 2.4e-7, bf16 7.6e-3
    assert _rel(kt, kj) < TOL[dtype] and _rel(vt, vj) < TOL[dtype]


@pytest.mark.parametrize("S", [5, 8, 13, 21])
def test_prime_ring_matches_jax(S):
    """S < W (unreached slots zero), S == W, S > W and S > 2W: bit for bit."""
    W = 8
    k = np.random.default_rng(S).normal(size=(2, S, 3, 4)).astype(np.float32)
    got = lm._prime_ring(torch.from_numpy(k), W)
    exp = np.asarray(jlm._prime_ring(jnp.asarray(k), W))
    np.testing.assert_array_equal(got.numpy(), exp)
    for t in range(max(0, S - W), S):          # each slot holds its token
        np.testing.assert_array_equal(got[:, t % W].numpy(), k[:, t])
    assert not got[:, S:].any()                # slots no token reached


def _decode_problem(dtype, seed=7):
    rng = np.random.default_rng(seed)
    d, H, KH, hd = 32, 4, 2, 8
    p, pt = _attn_params(rng, d, H, KH, hd, False, dtype)
    return rng, p, pt, (d, H, KH, hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S0", [5, 8, 13])
@pytest.mark.parametrize("layout", ["ring", "full"])
def test_windowed_decode_matches_jax_past_the_wrap(layout, S0, dtype):
    """Prefill S0 tokens (the ring primed with S0 < W, == W, > W), then
    decode 3W steps past the ring's first wrap, each step against the
    reference's on the same input cache; the ring's output also against
    the windowed full forward at that position (float32).  ``full``: a cache
    of S_max > W slots masked to the window."""
    W, B = 8, 2
    rng, p, pt, (d, H, KH, hd) = _decode_problem(dtype)
    S_total = max(S0, W) + 3 * W + 1      # the first wrap, then 3W steps
    x = rng.normal(size=(B, S_total, d)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    # the reference's inputs are sliced in numpy: an eager JAX slice
    # compiles once per start position
    xn = np.asarray(xj)
    csn = [np.asarray(a) for a in jlayers.rope_cos_sin(jnp.arange(S_total), hd, 1e4)]
    cst = layers.rope_cos_sin(torch.arange(S_total), hd, 1e4)
    _, (kj, vj) = j_forward(p, xn[:, :S0], (csn[0][:S0], csn[1][:S0]),
                            window=W, q_chunk=4, kv_chunk=4, return_kv=True)
    S_c = W if layout == "ring" else S_total
    ck = np.asarray(jlm._prime_ring(kj, S_c), np.float32)
    cv = np.asarray(jlm._prime_ring(vj, S_c), np.float32)
    full_y = None
    if dtype == "float32":
        full_y = attention.attn_forward(pt, xt, cst, window=W, q_chunk=4, kv_chunk=4)
    for pos in range(S0, S_total):
        ckj, cvj = jnp.asarray(ck, JDT[dtype]), jnp.asarray(cv, JDT[dtype])
        ckt = torch.from_numpy(np.array(ckj, np.float32)).to(TDT[dtype])
        cvt = torch.from_numpy(np.array(cvj, np.float32)).to(TDT[dtype])
        rot_j = (csn[0][pos:pos + 1], csn[1][pos:pos + 1])
        rot_t = (cst[0][pos:pos + 1], cst[1][pos:pos + 1])
        yj, ckj, cvj = j_decode(p, xn[:, pos:pos + 1], rot_j, ckj, cvj, jnp.int32(pos),
                                window=W)
        yt, ckt2, cvt2 = attention.attn_decode_step(pt, xt[:, pos:pos + 1], rot_t, ckt,
                                                    cvt, pos, window=W)
        assert ckt2 is ckt and cvt2 is cvt     # written in place
        assert _rel(yt, yj) < TOL[dtype], pos  # f32 <= 2.4e-7, bf16 <= 7.8e-3
        assert _rel(ckt, ckj) < TOL[dtype] and _rel(cvt, cvj) < TOL[dtype], pos
        if full_y is not None:                 # ring == windowed prefill
            assert _rel(yt[:, 0], full_y[:, pos].numpy()) < TOL[dtype], pos
        ck, cv = np.asarray(ckj, np.float32), np.asarray(cvj, np.float32)


def test_full_cache_range_check_spares_the_ring():
    """The full cache refuses a position past its end; a ring takes any."""
    _, p, pt, (d, H, KH, hd) = _decode_problem("float32")
    x = torch.zeros(1, 1, d)
    ck, cv = torch.zeros(1, 8, KH, hd), torch.zeros(1, 8, KH, hd)
    with pytest.raises(ValueError, match="outside the cache"):
        attention.attn_decode_step(pt, x, None, ck, cv, 8)
    with pytest.raises(ValueError, match="outside the cache"):
        attention.attn_decode_step(pt, x, None, ck, cv, 8, window=4)   # full + window
    y, _, _ = attention.attn_decode_step(pt, x, None, ck, cv, 8 * 5 + 3, window=8)
    assert y.shape == (1, 1, d)
