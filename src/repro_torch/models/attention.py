"""GQA attention: chunked-causal (prefill) and cached decode paths.

Prefill uses the reference's online-softmax chunked schedule, ported as
written: q is processed in static chunks, each attending to its causal kv
range in kv tiles, with scores and sums in float32 and masked scores at
``NEG_INF``, so the (S x S) score matrix never materialises.  These are
plain PyTorch ops (attention is not a Pallas kernel in the reference
package either); ``scaled_dot_product_attention`` would compute another
schedule, so it is not used.

Decode attends one token to its cache in float32, masked by position.
Rotary positions (``cos_sin``) rotate q and k after the qk-norm, so the
cache holds rotated keys.  Sliding-window layers (``attn_local``) pass
``window``: prefill then attends each q chunk to the static band
``[q_end - window - q_chunk, q_end)`` under the mask ``qpos - kpos <
window``, and decode reads a ring of ``window`` slots (slot ``pos % window``
holds the newest token) or a full cache masked to the window.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, normal, rms_head_norm

__all__ = ["NEG_INF", "init_attn", "attn_shapes", "repeat_kv", "mha_chunked", "attn_forward",
           "attn_decode_step"]

NEG_INF = -1e30


def init_attn(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              d_head: int, qk_norm: bool = False, qkv_bias: bool = False,
              dtype=torch.bfloat16):
    sc = 1.0 / math.sqrt(d)
    dev = gen.device
    p = {
        "wq": normal(gen, (d, n_heads, d_head), dtype, sc),
        "wk": normal(gen, (d, n_kv, d_head), dtype, sc),
        "wv": normal(gen, (d, n_kv, d_head), dtype, sc),
        "wo": normal(gen, (n_heads, d_head, d), dtype,
                     1.0 / math.sqrt(n_heads * d_head)),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads, d_head), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv, d_head), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv, d_head), dtype=dtype, device=dev)
    if qk_norm:
        p["q_norm"] = torch.ones((d_head,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((d_head,), dtype=torch.float32, device=dev)
    return p


def attn_shapes(d: int, n_heads: int, n_kv: int, d_head: int, qk_norm: bool = False,
                qkv_bias: bool = False, dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)} of :func:`init_attn`'s parameters."""
    p = {
        "wq": ((d, n_heads, d_head), dtype),
        "wk": ((d, n_kv, d_head), dtype),
        "wv": ((d, n_kv, d_head), dtype),
        "wo": ((n_heads, d_head, d), dtype),
    }
    if qkv_bias:
        p["bq"] = ((n_heads, d_head), dtype)
        p["bk"] = ((n_kv, d_head), dtype)
        p["bv"] = ((n_kv, d_head), dtype)
    if qk_norm:
        p["q_norm"] = ((d_head,), torch.float32)
        p["k_norm"] = ((d_head,), torch.float32)
    return p


def _project_qkv(params, x: torch.Tensor):
    """x (B, S, d) -> q (B, S, H, hd), k/v (B, S, KH, hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if "q_norm" in params:
        q = rms_head_norm(params["q_norm"], q)
        k = rms_head_norm(params["k_norm"], k)
    return q, k, v


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KH, hd) -> (B, S, KH*groups, hd), each kv head repeated for
    its query group."""
    if groups == 1:
        return k
    B, S, KH, hd = k.shape
    return k[:, :, :, None].expand(B, S, KH, groups, hd).reshape(B, S, KH * groups, hd)


def _mm_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum accumulated in float32 (``preferred_element_type=f32``): the
    products of two bf16 values are exact in float32, so upcasting first
    computes the same sum."""
    return torch.einsum(eq, a.float(), b.float())


def _attend_tile(q, k, v, mask):
    """q (B,H,qc,hd), k/v (B,H,kc,hd), mask (qc,kc) bool -> the tile's
    (scores max, exp sum, weighted v) for the online softmax."""
    s = _mm_f32("bhqd,bhkd->bhqk", q, k)
    s = torch.where(mask[None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(-1)
    o = _mm_f32("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return m, l, o


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KH,hd) -> (B,S,H,hd): exact-FLOPs chunked
    causal attention, kv heads repeated to H; ``window`` adds the
    sliding-window band (each q chunk reads only the keys its band can
    reach, tiled from ``kv_start`` as the reference tiles them)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    in_dtype = q.dtype
    scale = 1.0 / math.sqrt(hd)
    q = (q * scale).transpose(1, 2)                   # B,H,S,hd
    kT = repeat_kv(k, G).transpose(1, 2)
    vT = repeat_kv(v, G).transpose(1, 2)

    q_chunk = min(q_chunk, S)
    while S % q_chunk:
        q_chunk //= 2
    outs = []
    for i in range(S // q_chunk):
        q_start, q_end = i * q_chunk, (i + 1) * q_chunk
        kv_start = 0 if window is None else max(0, q_end - window - q_chunk)
        kv_len = (q_end if causal else S) - kv_start
        qi = q[:, :, q_start:q_end]
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32, device=q.device)
        qpos = q_start + torch.arange(q_chunk, device=q.device)
        for j in range(max(1, math.ceil(kv_len / kv_chunk))):
            ks_, ke_ = kv_start + j * kv_chunk, kv_start + min((j + 1) * kv_chunk, kv_len)
            kpos = ks_ + torch.arange(ke_ - ks_, device=q.device)
            mask = torch.ones((q_chunk, ke_ - ks_), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            mt, lt, ot = _attend_tile(qi, kT[:, :, ks_:ke_], vT[:, :, ks_:ke_], mask)
            m_new = torch.maximum(m, mt)
            c_old = torch.exp(m - m_new)
            c_new = torch.exp(mt - m_new)
            l = l * c_old + lt * c_new
            acc = acc * c_old[..., None] + ot * c_new[..., None]
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    o = torch.cat(outs, dim=2)                        # B,H,S,hd
    return o.transpose(1, 2).to(in_dtype)


def _rotate(q: torch.Tensor, k: torch.Tensor, cos_sin):
    """q and k rotated by ``cos_sin`` = (cos, sin), or as they are when it
    is None or holds None (a model without rotary positions)."""
    if cos_sin is None or cos_sin[0] is None:
        return q, k
    cos, sin = cos_sin
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def attn_forward(params, x: torch.Tensor, cos_sin=None, *,
                 window: Optional[int] = None, q_chunk: int = 512,
                 kv_chunk: int = 1024, return_kv: bool = False):
    """Full-sequence attention (prefill): x (B, S, d) -> (B, S, d), and with
    ``return_kv`` also the (k, v) the cache keeps, (B, S, KH, hd) each, the
    keys rotated.  ``cos_sin``: (cos, sin) of the positions, (S, hd/2) or
    (B, S, hd/2), or None.  ``window``: the sliding-window band of an
    ``attn_local`` layer, or None."""
    q, k, v = _project_qkv(params, x)
    q, k = _rotate(q, k, cos_sin)
    o = mha_chunked(q.to(x.dtype), k.to(x.dtype), v, window=window,
                    q_chunk=q_chunk, kv_chunk=kv_chunk)
    y = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), params["wo"])
    if return_kv:
        return y, (k.to(x.dtype), v)
    return y


def attn_decode_step(params, x: torch.Tensor, cos_sin, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, *,
                     window: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """One-token decode: x (B, 1, d); cache_k/v (B, S_c, KH, hd); ``pos``
    the token's absolute position; ``cos_sin`` the rotation at ``pos``,
    (1, hd/2) or (B, 1, hd/2), or None.

    Two cache layouts, as in the reference:
    * full (S_c = S_max > pos): the token goes to slot ``pos``; with a
      ``window`` the keys further back than the window are masked;
    * ring (``window`` given and S_c == window, an ``attn_local`` layer):
      the token goes to slot ``pos % S_c``, and slot i holds the token at
      ``pos - ((pos - i) mod S_c)``, valid when that is >= 0.

    The new key and value are written into ``cache_k`` / ``cache_v`` IN
    PLACE (the reference returns updated copies; writing in place saves
    copying the whole cache every token) and the same tensors are
    returned.  Returns (y (B, 1, d), cache_k, cache_v).
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x)
    q, k_new = _rotate(q, k_new, cos_sin)
    S_c = cache_k.shape[1]
    ring = window is not None and S_c == window
    if not ring and not 0 <= pos < S_c:
        raise ValueError(f"position {pos} is outside the cache of {S_c}")
    slot = pos % S_c if ring else pos
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)

    KH = cache_k.shape[2]
    H, hd = q.shape[2], q.shape[3]
    G = H // KH
    qh = (q * (1.0 / math.sqrt(hd))).reshape(B, KH, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qh.float(), cache_k.float())
    idx = torch.arange(S_c, device=x.device)
    if ring:
        valid = pos - torch.remainder(pos - idx, S_c) >= 0
    else:
        valid = idx <= pos
        if window is not None:
            valid &= (pos - idx) < window
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
    o = o.reshape(B, 1, H, hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return y, cache_k, cache_v
