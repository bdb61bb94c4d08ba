"""Shared model layers: RMS norms, rotary positions, the embedding and the
MLPs.

Pure-function style as in the reference package: ``init_*`` returns a dict of
tensors, the apply functions take (params, x).  Every ``init_*`` takes an
explicit ``torch.Generator`` and device.  Logical sharding annotations come
from ``distributed.sharding.shard`` (no-ops without rules).  Also the positions (rotary,
multimodal rotary, sinusoidal) and the loss: cross entropy fused with the
head's product, by sequence chunks.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    P,
    current_rules,
    partial_over,
    recompute_context,
    resolve_spec,
    shard,
    shard_map_compat,
)

__all__ = ["normal", "init_rmsnorm", "rmsnorm", "rms_head_norm", "rope_freqs",
           "rope_cos_sin", "apply_rope", "mrope_cos_sin", "sinusoidal_positions",
           "init_mlp", "mlp_shapes", "apply_mlp", "init_embedding", "embed",
           "lm_head_logits_chunk", "chunked_ce_loss"]


def normal(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    """Standard-normal draws in ``dtype`` times ``scale`` (the product taken
    in ``dtype``, as ``jax.random.normal(key, shape, dtype) * scale`` is), on
    the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype) * scale


# ---------------------------------------------------------------------------
# norms


def init_rmsnorm(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(x.ndim - 1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """Per-head RMS norm (qk-norm): x (..., hd), scale (hd,)."""
    xf = x.float()
    var = xf.square().mean(x.ndim - 1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for RoPE: (d_rot/2,) float32."""
    exponents = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, d_rot: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, d_rot/2) in float32."""
    inv = rope_freqs(d_rot, theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) with leading rotary half-pairs; cos/sin (B, S, hd/2)
    or (S, hd/2).  Rotates the pairs (x1, x2) = (x[..., :hd/2],
    x[..., hd/2:]) in float32 (NeoX / llama convention) and returns x's
    dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.ndim == 2:  # (S, half) -> broadcast over batch and heads
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    r1 = x1 * cos_b - x2 * sin_b
    r2 = x2 * cos_b + x1 * sin_b
    return torch.cat([r1, r2], dim=x.ndim - 1).to(x.dtype)


def mrope_cos_sin(pos_ids: torch.Tensor, sections: Tuple[int, ...], d_rot: int,
                  theta: float):
    """Multimodal RoPE (Qwen2-VL): pos_ids (3, B, S) for (t, h, w).

    The d_rot/2 frequency slots are split into ``len(sections)`` contiguous
    groups; group g rotates by ``pos_ids[g]``.  Returns cos/sin (B, S,
    d_rot/2) float32."""
    if sum(sections) != d_rot // 2:
        raise ValueError(f"mrope sections {sections} do not cover d_rot/2 = {d_rot // 2}")
    inv = rope_freqs(d_rot, theta, pos_ids.device)
    ang_all = pos_ids[..., None].float() * inv               # (3, B, S, d_rot/2)
    starts = [sum(sections[:g]) for g in range(len(sections))]
    ang = torch.cat([ang_all[g, ..., st:st + sec]
                     for g, (st, sec) in enumerate(zip(starts, sections))], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def sinusoidal_positions(S: int, d: int, offset=0, device=None) -> torch.Tensor:
    """MusicGen's fixed sinusoidal position embeddings of positions
    ``offset + [0, S)``: (S, d) float32, sines then cosines."""
    pos = torch.arange(S, dtype=torch.float32, device=device) + offset
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs


def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype=torch.bfloat16):
    p = {
        "w_up": normal(gen, (d, d_ff), dtype, 1.0 / math.sqrt(d)),
        "w_down": normal(gen, (d_ff, d), dtype, 1.0 / math.sqrt(d_ff)),
    }
    if act == "swiglu":
        p["w_gate"] = normal(gen, (d, d_ff), dtype, 1.0 / math.sqrt(d))
    return p


def mlp_shapes(d: int, d_ff: int, act: str, dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)} of :func:`init_mlp`'s parameters."""
    p = {"w_up": ((d, d_ff), dtype), "w_down": ((d_ff, d), dtype)}
    if act == "swiglu":
        p["w_gate"] = ((d, d_ff), dtype)
    return p


def apply_mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d); hidden sharded over tp.  ``gelu`` is the
    tanh form, as ``jax.nn.gelu`` computes it by default.  Under sharding
    rules the sequence-sharded residual is gathered first, as the attention
    and recurrent blocks gather it (DTensor's matmul flattens (B, S) and
    cannot flatten a sharded S)."""
    x = shard(x, "dp", None, None)
    up = x @ params["w_up"]
    up = shard(up, "dp", None, "tp")
    if act == "swiglu":
        gate = x @ params["w_gate"]
        gate = shard(gate, "dp", None, "tp")
        h = F.silu(gate.float()).to(x.dtype) * up
    elif act == "gelu":
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return shard(h @ params["w_down"], "dp", None, None)


# ---------------------------------------------------------------------------
# embedding


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16):
    return {"table": normal(gen, (vocab, d), dtype, 0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d).  Under sharding rules the lookup runs
    on local shards, the table gathered whole (DTensor's gradient of an
    indexed lookup, an index_put, failed: its placement rule makes a
    Shard(-1)); each data shard's tokens add a partial sum to the table's
    gradient."""
    table = params["table"]
    rules = current_rules()
    if rules is None or not isinstance(table, DTensor):
        return shard(table[tokens], "dp", "sp", None)
    ts = resolve_spec(rules, tokens.shape, ("dp", None))
    out = shard_map_compat(
        lambda t, ids: t[ids], mesh=rules.mesh, in_specs=(P(None, None), ts),
        out_specs=P(ts[0], None, None),
        in_grad_placements=(partial_over(rules.mesh, P(None, None), ts[0]), None),
    )(table, tokens)
    return shard(out, "dp", "sp", None)


# ---------------------------------------------------------------------------
# loss


def lm_head_logits_chunk(table_f32: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, C, d) against the head ``table_f32`` (V, d), already upcast to
    float32 -> (B, C, V) float32 logits: float32 sums of the products, as the
    reference's ``preferred_element_type=f32`` asks (a bf16 product is exact
    in float32, so upcasting the operands first computes the same sum)."""
    return shard(x.float() @ table_f32.T, "dp", None, "tp")


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, C, V) at labels (B, C): (B, C)."""
    return torch.gather(logits, 2, labels.long()[..., None])[..., 0]


def _ce_chunk(table_f32, x, labels, z_loss: float) -> torch.Tensor:
    # Under sharding rules the logits come vocab-sharded (dp, None, tp), as
    # the reference lays them out; DTensor's gather of the gold logit along
    # a sharded vocab fails (its masked partial sum), so the chunk's logits
    # are gathered whole over the vocab for the loss.  The gold logit is
    # then taken on each rank's batch shard: DTensor's backward of the
    # gather starts from ``new_zeros`` of the GLOBAL (B, C, V) shape,
    # replicated on every rank (79.7 GB at Qwen3's train_4k, the dry run).
    logits = shard(lm_head_logits_chunk(table_f32, x), "dp", None, None)
    last = logits.ndim - 1     # dims non-negative: DTensor's rules refuse Shard(-1)
    lse = torch.logsumexp(logits, dim=last)
    rules = current_rules()
    if rules is None or not isinstance(logits, DTensor):
        gold = _gold(logits, labels)
    else:
        b = resolve_spec(rules, labels.shape, ("dp", None))[0]
        gold = shard_map_compat(_gold, mesh=rules.mesh, in_specs=(P(b, None, None), P(b, None)),
                                out_specs=P(b, None))(logits, labels)
    loss = (lse - gold).sum()
    if z_loss:
        loss = loss + z_loss * lse.square().sum()
    return loss


def chunked_ce_loss(table: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512, z_loss: float = 0.0) -> torch.Tensor:
    """Cross entropy fused with the head's product, by sequence chunks:
    x (B, S, d), labels (B, S) int -> the mean loss over B * S, float32.

    The head table is upcast to float32 once per call.  Each chunk runs
    under ``torch.utils.checkpoint``, so its (B, chunk, V) logits are
    recomputed in the backward and the (B, S, V) logits are never all held
    (152064 x 4096 x 4 bytes = 2.5 GB a sequence for Qwen2-VL)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the loss chunk {chunk}")
    table_f32 = table.float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_ce_chunk, table_f32, x[:, sl], labels[:, sl], z_loss,
                                   use_reentrant=False, context_fn=recompute_context())
    return total / (B * S)
