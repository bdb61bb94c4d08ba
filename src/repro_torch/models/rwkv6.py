"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

The WKV recurrence per head (state S is a (dk, dv) matrix):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t            (w_t in (0,1), data-dep.)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
From a zero state with ``use_kernel`` (training and prefill), it runs
through the WKV kernel in the forward of :class:`WkvFused`, whose backward
is a reverse chunk scan restarting from the kernel's chunk-entry states;
otherwise, and always from a carried state (decode), by chunks: within a
chunk the (decay, update) pairs are scanned step by step, chunks chained by
a Python loop (``kernels.ref.wkv_chunked``), and autograd runs through it.

As in the reference, the decay w_t is data-dependent through a LoRA and the
five token-shift lerp factors are learned per-channel constants.  Under
sharding rules the projections shard over "tp" and the scan (kernel or
plain) runs on each rank's (dp, tp-on-heads) shard.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    P,
    current_rules,
    mesh_sizes,
    partial_over,
    shard,
    shard_map_compat,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv_chunked
from repro_torch.models.layers import normal

__all__ = ["init_rwkv_tmix", "rwkv_tmix_shapes", "rwkv_tmix_forward",
           "init_rwkv_cmix", "rwkv_cmix_shapes", "rwkv_cmix_forward",
           "rwkv_state_shapes", "WkvFused", "wkv_backward"]

LORA_RANK = 64


def _heads(d_model: int, head_dim: int, tp: int = 1) -> int:
    """Head count padded up to a multiple of ``tp`` (the parameter layout
    the reference keeps for tensor parallelism; ``rwkv6_3b`` pads 40 heads to
    48)."""
    return int(math.ceil(d_model // head_dim / tp) * tp)


def init_rwkv_tmix(gen: torch.Generator, d_model: int, *, head_dim: int = 64,
                   tp_pad: int = 1, dtype=torch.bfloat16):
    H = _heads(d_model, head_dim, tp_pad)
    d_attn = H * head_dim
    sc = 1.0 / math.sqrt(d_model)
    dev = gen.device
    return {
        "mu": torch.full((5, d_model), 0.5, dtype=dtype, device=dev),  # w,k,v,r,g
        "w_r": normal(gen, (d_model, d_attn), dtype, sc),
        "w_k": normal(gen, (d_model, d_attn), dtype, sc),
        "w_v": normal(gen, (d_model, d_attn), dtype, sc),
        "w_g": normal(gen, (d_model, d_attn), dtype, sc),
        "w_o": normal(gen, (d_attn, d_model), dtype, 1.0 / math.sqrt(d_attn)),
        "w_decay_base": torch.full((d_attn,), -6.0, dtype=torch.float32, device=dev),
        "w_decay_a": normal(gen, (d_model, LORA_RANK), dtype, sc),
        "w_decay_b": normal(gen, (LORA_RANK, d_attn), dtype, 1.0 / math.sqrt(LORA_RANK)),
        "u": torch.zeros((H, head_dim), dtype=torch.float32, device=dev),  # bonus
        "ln_scale": torch.ones((d_attn,), dtype=torch.float32, device=dev),
    }


def rwkv_tmix_shapes(d_model: int, *, head_dim: int = 64, tp_pad: int = 1,
                     dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)} of :func:`init_rwkv_tmix`'s parameters."""
    H = _heads(d_model, head_dim, tp_pad)
    d_attn = H * head_dim
    return {
        "mu": ((5, d_model), dtype),
        "w_r": ((d_model, d_attn), dtype),
        "w_k": ((d_model, d_attn), dtype),
        "w_v": ((d_model, d_attn), dtype),
        "w_g": ((d_model, d_attn), dtype),
        "w_o": ((d_attn, d_model), dtype),
        "w_decay_base": ((d_attn,), torch.float32),
        "w_decay_a": ((d_model, LORA_RANK), dtype),
        "w_decay_b": ((LORA_RANK, d_attn), dtype),
        "u": ((H, head_dim), torch.float32),
        "ln_scale": ((d_attn,), torch.float32),
    }


def rwkv_state_shapes(B: int, d_model: int, *, head_dim: int = 64,
                      tp_pad: int = 1) -> dict:
    """{name: (shape, dtype)} of one layer's serve state."""
    H = _heads(d_model, head_dim, tp_pad)
    return {
        "shift_t": ((B, d_model), torch.bfloat16),
        "shift_c": ((B, d_model), torch.bfloat16),
        "wkv": ((B, H, head_dim, head_dim), torch.float32),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, S, d) shifted right one step; ``prev`` is the last token of the
    previous segment (decode), zeros without one."""
    if prev is None:
        first = torch.zeros_like(x[:, :1])
    else:
        first = prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_chunked(w, k, v, r, u, S0, chunk: int):
    """w, k, r (B, S, H, dk) f32, v (B, S, H, dv) -> y (B, S, H, dv) and the
    final state (B, H, dk, dv)."""
    y, S_fin, _ = wkv_chunked(w, k, v, r, u, S0, chunk)
    return y, S_fin


def wkv_backward(w, k, v, r, u, s_bounds, y_bar, sfin_bar) -> tuple:
    """The WKV scan's backward, the reference's ``_wkv_bwd``: the gradients
    of (w, k, v, r, u) from those of y (B, S, H, dv) and of the final state
    (B, H, dk, dv), given the inputs and the chunk-entry states ``s_bounds``
    (B, nc, H, dk, dv) the forward wrote.

    Chunks run in reverse, each restarting from its entry state.  Within a
    chunk, the states before each step and the state gradients
        G_t = dL/dS_t = r_{t+1} (x) ybar_{t+1} + w_{t+1} G_{t+1}
    (G at the chunk's last step is the carry from the chunk after) are
    scanned step by step: a product of decays is never divided out, since
    w = exp(-exp(.)) underflows within a chunk.  The (B, c, H, dk, dv)
    tensors exist one chunk at a time."""
    B, S, H, dk = k.shape
    nc = s_bounds.shape[1]
    c = S // nc
    uk = u[None, None, :, :]                                    # (1,1,H,dk)
    grads = {name: torch.empty_like(t) for name, t in (("w", w), ("k", k), ("v", v),
                                                       ("r", r))}
    u_bar = torch.zeros_like(u)
    gbar = sfin_bar
    for ci in reversed(range(nc)):
        sl = slice(ci * c, (ci + 1) * c)
        w_i, k_i, v_i, r_i, yb_i = (t[:, sl] for t in (w, k, v, r, y_bar))
        a = w_i[..., None]                                       # (B,c,H,dk,1)
        # the state before each step of the chunk, from its entry state
        b = k_i[..., None] * v_i[..., None, :]                   # (B,c,H,dk,dv)
        states = [s_bounds[:, ci]]
        for t in range(c - 1):
            states.append(torch.addcmul(b[:, t], a[:, t], states[-1]))
        S_prev = torch.stack(states, 1)
        del states, b
        # G_t, from the carry at the chunk's last step backwards
        P = r_i[..., None] * yb_i[..., None, :]                  # dL/d(S_prev_t + u b_t)
        Gs = [gbar]
        for t in range(c - 1, 0, -1):
            Gs.append(torch.addcmul(P[:, t], a[:, t], Gs[-1]))
        G = torch.stack(Gs[::-1], 1)                             # (B,c,H,dk,dv)
        del Gs
        vy = (v_i * yb_i).sum(-1, keepdim=True)                  # (B,c,H,1)
        grads["w"][:, sl] = torch.einsum("bchkv,bchkv->bchk", G, S_prev)
        grads["k"][:, sl] = torch.einsum("bchkv,bchv->bchk", G, v_i) + uk * r_i * vy
        grads["v"][:, sl] = (torch.einsum("bchkv,bchk->bchv", G, k_i)
                             + (uk * r_i * k_i).sum(-1, keepdim=True) * yb_i)
        grads["r"][:, sl] = torch.einsum("bchkv,bchv->bchk", S_prev, yb_i) + uk * k_i * vy
        u_bar += (r_i * k_i * vy).sum((0, 1))
        # dL/d(the chunk's entry state): through step 0's update and its output
        gbar = torch.addcmul(P[:, 0], a[:, 0], G[:, 0])
    return grads["w"], grads["k"], grads["v"], grads["r"], u_bar


class WkvFused(torch.autograd.Function):
    """The WKV scan from a zero state with a custom backward, the reference's
    ``wkv_fused``: w, k, r (B, S, H, dk), v (B, S, H, dv), u (H, dk), float32
    -> (y (B, S, H, dv), S_fin (B, H, dk, dv)).

    The forward is ``ops.wkv_scan`` (the WKV kernel on the card, its plain
    version on the CPU), which also returns the chunk-entry states the
    backward (:func:`wkv_backward`) restarts from.  Under
    ``torch.utils.checkpoint`` the recomputed forward launches the kernel
    again and saves its own states."""

    @staticmethod
    def forward(ctx, w, k, v, r, u):
        y, s_fin, s_bounds = ops.wkv_scan(w, k, v, r, u)
        ctx.save_for_backward(w, k, v, r, u, s_bounds)
        return y, s_fin

    @staticmethod
    def backward(ctx, y_bar, sfin_bar):
        return wkv_backward(*ctx.saved_tensors, y_bar.contiguous(), sfin_bar)


def _dp_tp(rules, B: int, n: int):
    """The reference's divisibility fallbacks: the batch spec (the dp mesh
    dimensions, or None if they do not divide B) and the spec of a tp-split
    dimension of n (``"model"``, or None)."""
    sizes = mesh_sizes(rules.mesh)
    dp, tp = rules.physical("dp"), rules.physical("tp")
    dpN = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        dpN *= sizes[a]
    return (dp if B % dpN == 0 else None), (tp if n % sizes[tp] == 0 else None)


def _wkv_mix(w, k, v, r, g, u, ln_scale, S0, *, head_dim: int, chunk: int,
             use_kernel: bool, dtype):
    """From the projections (B, S, d_attn) to the gated, normalised WKV
    output (B, S, d_attn) and the final state: the heads, the scan (the
    kernel through ``WkvFused`` from a zero state, S0 None, or the chunked
    plain scan from S0), the per-head group norm and the silu gate."""
    B, S, _ = k.shape
    H = u.shape[0]
    heads = [t.reshape(B, S, H, head_dim).float() for t in (w, k, v, r)]
    if use_kernel:
        y, S_fin = WkvFused.apply(*heads, u)
    else:
        y, S_fin = _wkv_chunked(*heads, u, S0, chunk)
    # group norm over heads (per-head standardisation; population variance)
    yh = y.reshape(B, S, H, head_dim)
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mean) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, H * head_dim) * ln_scale[None, None]
    return y.to(dtype) * F.silu(g.float()).to(dtype), S_fin


def _wkv_call(w, k, v, r, g, u, ln_scale, S0, **kw):
    """:func:`_wkv_mix`; under sharding rules on each rank's shard, batch
    over dp and heads over tp, the layout of the reference's
    ``_wkv_kernel_call`` (an axis that does not divide is replicated; the
    head split and the group norm stay local, where DTensor's reshape of a
    sharded dimension may not go)."""
    mix = functools.partial(_wkv_mix, **kw)
    rules = current_rules()
    if rules is None or not isinstance(k, DTensor):
        return mix(w, k, v, r, g, u, ln_scale, S0)
    b, h = _dp_tp(rules, k.shape[0], u.shape[0])
    rows, state = P(b, None, h), P(b, h, None, None)
    mesh = rules.mesh
    # u and ln_scale serve every batch shard: partial-sum gradients over dp
    return shard_map_compat(
        mix, mesh=mesh,
        in_specs=(rows,) * 5 + (P(h, None), P(h), None if S0 is None else state),
        out_specs=(rows, state),
        in_grad_placements=(None,) * 5 + (partial_over(mesh, P(h, None), b),
                                          partial_over(mesh, P(h), b), None),
    )(w, k, v, r, g, u, ln_scale, S0)


def rwkv_tmix_forward(params, x: torch.Tensor, *, head_dim: int = 64,
                      chunk: int = 16, state=None, return_state: bool = False,
                      use_kernel: bool = False):
    """x (B, S, d_model) -> (B, S, d_model); with ``return_state`` also the
    layer's new {shift_t, wkv} state."""
    x = shard(x, "dp", None, None)
    B, S, d = x.shape
    prev = None if state is None else state["shift_t"]
    xs = _token_shift(x, prev)
    mu = params["mu"]
    xw, xk, xv, xr, xg = [x + (xs - x) * mu[i][None, None] for i in range(5)]

    r = xr @ params["w_r"]
    k = xk @ params["w_k"]
    v = xv @ params["w_v"]
    g = xg @ params["w_g"]
    r, k, v, g = (shard(t, "dp", None, "tp") for t in (r, k, v, g))
    decay_raw = (params["w_decay_base"]
                 + (torch.tanh((xw @ params["w_decay_a"]).float())
                    @ params["w_decay_b"].float()))
    w = torch.exp(-torch.exp(torch.clamp(decay_raw, -20.0, 8.0)))  # (B,S,d_attn)

    H = params["u"].shape[0]
    use_kernel = use_kernel and state is None
    if state is not None:
        S0 = state["wkv"]
    elif use_kernel:
        S0 = None           # WkvFused starts from zeros itself
    else:
        S0 = torch.zeros((B, H, head_dim, head_dim), dtype=torch.float32, device=x.device)
    y, S_fin = _wkv_call(w, k, v, r, g, params["u"], params["ln_scale"], S0,
                         head_dim=head_dim, chunk=chunk, use_kernel=use_kernel,
                         dtype=x.dtype)
    out = shard(y @ params["w_o"], "dp", "sp", None)
    if return_state:
        return out, {"shift_t": x[:, -1].to(torch.bfloat16), "wkv": S_fin}
    return out


# ---------------------------------------------------------------------------
# channel mix


def init_rwkv_cmix(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype=torch.bfloat16):
    sc = 1.0 / math.sqrt(d_model)
    return {
        "mu": torch.full((2, d_model), 0.5, dtype=dtype, device=gen.device),  # k, r
        "w_k": normal(gen, (d_model, d_ff), dtype, sc),
        "w_v": normal(gen, (d_ff, d_model), dtype, 1.0 / math.sqrt(d_ff)),
        "w_r": normal(gen, (d_model, d_model), dtype, sc),
    }


def rwkv_cmix_shapes(d_model: int, d_ff: int, dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)} of :func:`init_rwkv_cmix`'s parameters."""
    return {
        "mu": ((2, d_model), dtype),
        "w_k": ((d_model, d_ff), dtype),
        "w_v": ((d_ff, d_model), dtype),
        "w_r": ((d_model, d_model), dtype),
    }


def rwkv_cmix_forward(params, x: torch.Tensor, *, state=None,
                      return_state: bool = False):
    """x (B, S, d_model) -> (B, S, d_model); with ``return_state`` also the
    layer's new {shift_c}."""
    x = shard(x, "dp", None, None)
    prev = None if state is None else state["shift_c"]
    xs = _token_shift(x, prev)
    mu = params["mu"]
    xk = x + (xs - x) * mu[0][None, None]
    xr = x + (xs - x) * mu[1][None, None]
    k = shard(xk @ params["w_k"], "dp", None, "tp")
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = k @ params["w_v"]
    out = torch.sigmoid((xr @ params["w_r"]).float()).to(x.dtype) * kv
    out = shard(out, "dp", "sp", None)
    if return_state:
        return out, {"shift_c": x[:, -1].to(torch.bfloat16)}
    return out
