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

Tensor parallelism follows Megatron, as in the reference: under sharding
rules heads shard over "tp", the residual is sequence-sharded ("sp")
outside the block and gathered to the full sequence inside; the decode
cache shards over the sequence.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.distributed.sharding import (
    P,
    current_rules,
    partial_over,
    placements,
    resolve_spec,
    shard,
    shard_map_compat,
)
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


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, h, hd) -> (B, S, h, hd).  Under sharding rules it
    runs on local shards laid out as the reference's annotations name them:
    x (dp, None, None), w gathered over fsdp with its heads on tp, the
    result (dp, None, tp, None).  (DTensor's own einsum may shard the
    flattened heads x hd product where the head count does not divide tp,
    then cannot unflatten it.)"""
    rules = current_rules()
    if rules is None or not isinstance(w, DTensor):
        return torch.einsum("bsd,dhk->bshk", x, w)
    xs = resolve_spec(rules, x.shape, ("dp", None, None))
    ws = resolve_spec(rules, w.shape, (None, "tp", None))
    mesh = rules.mesh
    # x serves every head shard, w every batch shard: partial-sum gradients
    return shard_map_compat(
        lambda a, b: torch.einsum("bsd,dhk->bshk", a, b), mesh=mesh, in_specs=(xs, ws),
        out_specs=P(xs[0], None, ws[1], None),
        in_grad_placements=(partial_over(mesh, xs, ws[1]), partial_over(mesh, ws, xs[0])),
    )(x, w)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d).  Under sharding rules on
    local shards: o (dp, None, tp, None), wo gathered over fsdp with its
    heads on tp, the result a partial sum over the head shards (DTensor's
    einsum would flatten the sharded heads with hd)."""
    rules = current_rules()
    if rules is None or not isinstance(wo, DTensor):
        return torch.einsum("bshk,hkd->bsd", o, wo)
    os_ = resolve_spec(rules, o.shape, ("dp", None, "tp", None))
    ws = resolve_spec(rules, wo.shape, ("tp", None, None))
    mesh = rules.mesh
    out = list(placements(mesh, P(os_[0], None, None)))
    if ws[0] is not None:                 # heads split over tp: sum the shards
        out[list(mesh.mesh_dim_names).index(ws[0])] = Partial()
    return shard_map_compat(
        lambda a, b: torch.einsum("bshk,hkd->bsd", a, b), mesh=mesh, in_specs=(os_, ws),
        out_specs=out,
        in_grad_placements=(None, partial_over(mesh, ws, os_[0])),
    )(o, wo)


def _project_qkv(params, x: torch.Tensor):
    """x (B, S, d) -> q (B, S, H, hd), k/v (B, S, KH, hd)."""
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if "q_norm" in params:
        q = rms_head_norm(params["q_norm"], q)
        k = rms_head_norm(params["k_norm"], k)
    q = shard(q, "dp", None, "tp", None)
    k = shard(k, "dp", None, "tp", None)
    v = shard(v, "dp", None, "tp", None)
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
    reach, tiled from ``kv_start`` as the reference tiles them).  Under
    sharding rules the chunk loop runs on each rank's (dp, tp-on-heads)
    shard, the layout the reference's annotations name (DTensor's einsum of
    a tile flattens a sharded dimension it cannot flatten)."""
    rules = current_rules()
    if rules is not None and isinstance(q, DTensor):
        G = q.shape[2] // k.shape[2]
        k = shard(repeat_kv(k, G), "dp", None, "tp", None)
        v = shard(repeat_kv(v, G), "dp", None, "tp", None)
        spec = resolve_spec(rules, q.shape, ("dp", None, "tp", None))
        local = functools.partial(_mha_chunked, causal=causal, window=window,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
        return shard_map_compat(local, mesh=rules.mesh, in_specs=(spec, spec, spec),
                                out_specs=spec)(q, k, v)
    return _mha_chunked(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)


def _mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                 window: Optional[int], q_chunk: int, kv_chunk: int) -> torch.Tensor:
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
    x = shard(x, "dp", None, None)  # gather the sequence for the block
    q, k, v = _project_qkv(params, x)
    q, k = _rotate(q, k, cos_sin)
    o = mha_chunked(q.to(x.dtype), k.to(x.dtype), v, window=window,
                    q_chunk=q_chunk, kv_chunk=kv_chunk)
    y = _out_proj(o.to(x.dtype), params["wo"])
    y = shard(y, "dp", "sp", None)  # back to the sequence-sharded residual
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
    cache_k = _write_slot(cache_k, k_new[:, 0].to(cache_k.dtype), slot)
    cache_v = _write_slot(cache_v, v_new[:, 0].to(cache_v.dtype), slot)

    KH = cache_k.shape[2]
    H, hd = q.shape[2], q.shape[3]
    G = H // KH
    # one token's query, gathered over its heads: a tp shard of the heads
    # need not hold whole kv groups, and the card's DTensor cannot split a
    # sharded dimension into (KH, G) (the cache is sequence-sharded anyway)
    q = shard(q, "dp", None, None, None)
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
    p = torch.softmax(s, dim=s.ndim - 1)
    o = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
    o = o.reshape(B, 1, H, hd).to(x.dtype)
    y = _out_proj(o, params["wo"])
    return shard(y, "dp", None, None), cache_k, cache_v


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """cache[:, slot] = new, IN PLACE; returns the cache.  A DTensor cache
    (sharded (dp, sp), the reference's decode layout) is written on the
    local shards: the rank whose sequence shard holds ``slot`` writes it."""
    rules = current_rules()
    if rules is None or not isinstance(cache, DTensor):
        cache[:, slot] = new
        return cache
    cache = shard(cache, "dp", "sp", None, None)
    spec = resolve_spec(rules, cache.shape, ("dp", "sp", None, None))
    mesh = rules.mesh

    def write(c, n):
        if spec[1] is None:
            c[:, slot] = n
            return c
        S_loc = c.shape[1]
        first = mesh.get_local_rank(spec[1]) * S_loc
        if first <= slot < first + S_loc:
            c[:, slot - first] = n
        return c

    return shard_map_compat(write, mesh=mesh, in_specs=(spec, P(spec[0], None, None)),
                            out_specs=spec)(cache, new)
