"""Mamba-1 block (as used by Jamba) with a chunked selective scan.

Selective SSM recurrence per channel d and state s:
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D x_t
From a zero state with ``use_kernel`` (training and prefill), the scan runs
through the selective-scan kernel (``ops.mamba_scan``, which folds ``D``
in) in the forward of :class:`MambaScanFused`, whose backward is a reverse
chunk scan restarting from the kernel's chunk-entry states.  Otherwise, and
always from a carried state (decode), the sequence is processed in chunks:
within a chunk the (decay, update) pairs are scanned step by step
(``kernels.ref.linear_scan``), chunks chained by a Python loop carrying the
(d_inner, d_state) state, and ``D x`` is added after; autograd runs through
it.
"""
from __future__ import annotations

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
from repro_torch.kernels.ref import linear_scan, scan_chunk
from repro_torch.models.layers import normal

__all__ = ["init_mamba", "mamba_shapes", "mamba_forward", "mamba_decode_step",
           "mamba_state_shapes", "MambaScanFused", "mamba_scan_backward"]


def _dims(d_model: int, expand: int):
    return expand * d_model, max(1, math.ceil(d_model / 16))


def init_mamba(gen: torch.Generator, d_model: int, *, expand: int = 2,
               d_state: int = 16, dconv: int = 4, dtype=torch.bfloat16):
    d_inner, dt_rank = _dims(d_model, expand)
    dev = gen.device
    sc = 1.0 / math.sqrt(d_model)
    sci = 1.0 / math.sqrt(d_inner)
    # S4D-real initialisation for A
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev).expand(d_inner, d_state)
    return {
        "w_in": normal(gen, (d_model, 2 * d_inner), dtype, sc),
        "conv_w": normal(gen, (dconv, d_inner), dtype, 1 / math.sqrt(dconv)),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_x": normal(gen, (d_inner, dt_rank + 2 * d_state), dtype, sci),
        "w_dt": normal(gen, (dt_rank, d_inner), dtype, 1 / math.sqrt(dt_rank)),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=torch.float32, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "w_out": normal(gen, (d_inner, d_model), dtype, sci),
    }


def mamba_shapes(d_model: int, *, expand: int = 2, d_state: int = 16,
                 dconv: int = 4, dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)} of :func:`init_mamba`'s parameters."""
    d_inner, dt_rank = _dims(d_model, expand)
    return {
        "w_in": ((d_model, 2 * d_inner), dtype),
        "conv_w": ((dconv, d_inner), dtype),
        "conv_b": ((d_inner,), dtype),
        "w_x": ((d_inner, dt_rank + 2 * d_state), dtype),
        "w_dt": ((dt_rank, d_inner), dtype),
        "dt_bias": ((d_inner,), torch.float32),
        "A_log": ((d_inner, d_state), torch.float32),
        "D": ((d_inner,), torch.float32),
        "w_out": ((d_inner, d_model), dtype),
    }


def mamba_state_shapes(B: int, d_model: int, *, expand: int = 2,
                       d_state: int = 16, dconv: int = 4) -> dict:
    """{name: (shape, dtype)} of one layer's serve state."""
    d_inner, _ = _dims(d_model, expand)
    return {
        "conv": ((B, dconv - 1, d_inner), torch.bfloat16),
        "ssm": ((B, d_inner, d_state), torch.float32),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_scan_chunked(params, dt_raw, Bm, Cm, x, h0, chunk: int):
    """dt_raw (B, S, dt_rank); Bm, Cm (B, S, d_state); x (B, S, d_inner);
    h0 (B, d_inner, d_state).  Returns y (B, S, d_inner) f32 without the
    ``D x`` term, and the final state.  The (B, chunk, d_inner, d_state)
    decay/update/state tensors exist per chunk only."""
    B, S, d_inner = x.shape
    chunk = scan_chunk(S, chunk)
    A = -torch.exp(params["A_log"])                           # (d, s) < 0
    y = torch.empty((B, S, d_inner), dtype=torch.float32, device=x.device)
    h = h0
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        dt = _softplus((dt_raw[:, sl] @ params["w_dt"]).float() + params["dt_bias"])
        a = torch.exp(dt[..., None] * A[None, None])          # (B,c,d,s)
        b = (dt * x[:, sl].float())[..., None] * Bm[:, sl].float()[:, :, None, :]
        A_cum, B_cum = linear_scan(a, b)
        h_chunk = A_cum * h[:, None] + B_cum
        y[:, sl] = torch.einsum("bcdn,bcn->bcd", h_chunk, Cm[:, sl].float())
        h = h_chunk[:, -1]
    return y, h


def mamba_scan_backward(dt, x, Bm, Cm, A_log, D, h_bounds, y_bar, hfin_bar) -> tuple:
    """The selective scan's backward, the reference's ``_fused_bwd``: the
    gradients of (dt, x, Bm, Cm, A_log, D) from those of y (B, S, d) and of
    the final state (B, d, s), given the inputs and the chunk-entry states
    ``h_bounds`` (B, nc, d, s) the forward wrote.

    Chunks run in reverse, each restarting from its entry state.  Within a
    chunk the states and the state gradients
        G_t = dL/dh_t = ybar_t C_t + a_{t+1} G_{t+1},   a_t = exp(dt_t A)
    (plus the carry from the chunk after at its last step) are scanned step
    by step: a product of decays is never divided out.  The (B, c, d, s)
    tensors exist one chunk at a time."""
    Bsz, S, d = dt.shape
    nc = h_bounds.shape[1]
    c = S // nc
    A = -torch.exp(A_log)                                       # (d, s)
    grads = {name: torch.empty_like(t) for name, t in (("dt", dt), ("x", x), ("B", Bm),
                                                       ("C", Cm))}
    A_bar = torch.zeros_like(A_log)
    gbar = hfin_bar
    for ci in reversed(range(nc)):
        sl = slice(ci * c, (ci + 1) * c)
        dt_i, x_i, B_i, C_i, yb_i = (t[:, sl] for t in (dt, x, Bm, Cm, y_bar))
        a = torch.exp(dt_i[..., None] * A[None, None])           # (B,c,d,s)
        b = (dt_i * x_i)[..., None] * B_i[:, :, None, :]
        hs = [h_bounds[:, ci]]                                   # the state before step 0
        for t in range(c):
            hs.append(torch.addcmul(b[:, t], a[:, t], hs[-1]))
        h_prev = torch.stack(hs[:-1], 1)                         # the state before each step
        h = torch.stack(hs[1:], 1)                               # the state after it
        del hs, b
        e = yb_i[..., None] * C_i[:, :, None, :]                 # dL/dh_t through y_t
        Gs = [e[:, -1] + gbar]
        for t in range(c - 2, -1, -1):
            Gs.append(torch.addcmul(e[:, t], a[:, t + 1], Gs[-1]))
        G = torch.stack(Gs[::-1], 1)                             # (B,c,d,s)
        del Gs, e
        ga = G * h_prev * a                                      # dL/d(dt A) per state
        GB = torch.einsum("bcds,bcs->bcd", G, B_i)
        grads["dt"][:, sl] = torch.einsum("bcds,ds->bcd", ga, A) + GB * x_i
        grads["x"][:, sl] = GB * dt_i + D[None, None] * yb_i
        grads["B"][:, sl] = torch.einsum("bcds,bcd->bcs", G, dt_i * x_i)
        grads["C"][:, sl] = torch.einsum("bcd,bcds->bcs", yb_i, h)
        A_bar += torch.einsum("bcds,bcd->ds", ga, dt_i)
        gbar = a[:, 0] * G[:, 0]
    # dA/dA_log = -exp(A_log) = A
    D_bar = torch.einsum("bsd,bsd->d", y_bar, x)
    return grads["dt"], grads["x"], grads["B"], grads["C"], A_bar * A, D_bar


class MambaScanFused(torch.autograd.Function):
    """The selective scan from a zero state, ``D`` folded in, with a custom
    backward, the reference's ``mamba_scan_fused``: dt, x (B, S, d) float32
    (dt after the softplus), Bm, Cm (B, S, s), A_log (d, s), D (d,) -> (y
    (B, S, d), h_fin (B, d, s)).

    The forward is ``ops.mamba_scan`` (the selective-scan kernel on the
    card, its plain version on the CPU), which also returns the chunk-entry
    states the backward (:func:`mamba_scan_backward`) restarts from.  Under
    ``torch.utils.checkpoint`` the recomputed forward launches the kernel
    again and saves its own states."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A_log, D):
        y, h_fin, h_bounds = ops.mamba_scan(dt, x, Bm, Cm, A_log, D)
        ctx.save_for_backward(dt, x, Bm, Cm, A_log, D, h_bounds)
        return y, h_fin

    @staticmethod
    def backward(ctx, y_bar, hfin_bar):
        return mamba_scan_backward(*ctx.saved_tensors, y_bar.contiguous(), hfin_bar)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Depthwise causal conv: x (B, S, d), w (dconv, d).  ``state`` holds the
    trailing dconv-1 inputs of the previous segment (decode).  The dconv
    terms are added in the reference's order (a Python ``sum``), so bf16
    rounds at the same places."""
    dconv = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], dconv - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S + dconv - 1, d)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i][None, None] for i in range(dconv))
    new_state = xp[:, xp.shape[1] - (dconv - 1):]
    return out + b[None, None], new_state


def _scan_call(params, dt_raw, Bm, Cm, x, h0, chunk: int, use_kernel: bool):
    """The selective scan: the kernel (``MambaScanFused``, from a zero
    state, D folded in) or the chunked plain scan from h0 (D added after).
    Returns (y float32, final state).  Under sharding rules it runs on each
    rank's shard, batch over dp and d_inner over tp (the reference's
    ``_kernel_scan`` specs; an axis that does not divide is replicated)."""
    def scan(dt_raw_, Bm_, Cm_, x_, h0_, w_dt, dt_bias, A_log, D):
        if use_kernel:
            dt = _softplus((dt_raw_ @ w_dt).float() + dt_bias)
            return MambaScanFused.apply(dt, x_.float(), Bm_.float(), Cm_.float(), A_log, D)
        p = {"w_dt": w_dt, "dt_bias": dt_bias, "A_log": A_log}
        y, h = _ssm_scan_chunked(p, dt_raw_, Bm_, Cm_, x_, h0_, chunk)
        return y + D[None, None] * x_.float(), h

    args = (dt_raw, Bm, Cm, x, h0, params["w_dt"], params["dt_bias"], params["A_log"],
            params["D"])
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return scan(*args)
    sizes = mesh_sizes(rules.mesh)
    dp, tp = rules.physical("dp"), rules.physical("tp")
    dpN = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        dpN *= sizes[a]
    b = dp if x.shape[0] % dpN == 0 else None
    d = tp if x.shape[2] % sizes[tp] == 0 else None
    rows = P(b, None, None)
    weights = (P(None, d), P(d), P(d, None), P(d))
    # the rows (dt_raw, B, C) serve every d_inner shard, the weights every
    # batch shard: their gradients are partial sums over tp and dp
    return shard_map_compat(
        scan, mesh=rules.mesh,
        in_specs=(rows, rows, rows, P(b, None, d), P(b, d, None)) + weights,
        out_specs=(P(b, None, d), P(b, d, None)),
        in_grad_placements=((partial_over(rules.mesh, rows, d),) * 3 + (None, None)
                            + tuple(partial_over(rules.mesh, w, b) for w in weights)),
    )(*args)


def _ssm_inner(params, xz: torch.Tensor, conv_state, h0, chunk: int,
               use_kernel: bool = False):
    """Everything after in_proj: xz (B, S, 2*d_inner) -> (y, conv state,
    final ssm state).  The kernel route folds ``D`` into the kernel; the
    chunked route adds it after the scan."""
    # under sharding rules xz arrives tp-sharded over its 2 * d_inner
    # columns, whose shards do not line up with the x and z halves: gather
    # it, split, and shard each half over tp (no-ops without rules)
    x, z = shard(xz, "dp", None, None).chunk(2, dim=2)
    x, z = shard(x, "dp", None, "tp"), shard(z, "dp", None, "tp")
    x, conv_state = _conv1d(x, params["conv_w"], params["conv_b"], conv_state)
    x = F.silu(x.float()).to(x.dtype)
    x = shard(x, "dp", None, "tp")
    proj = x @ params["w_x"]                                 # (B, S, dt_rank + 2*s)
    d_state = params["A_log"].shape[1]
    dt_rank = proj.shape[-1] - 2 * d_state
    dt_raw, Bm, Cm = proj.split([dt_rank, d_state, d_state], dim=2)
    y, h_last = _scan_call(params, dt_raw, Bm, Cm, x, h0, chunk, use_kernel)
    y = y * F.silu(z.float())
    return y.to(xz.dtype), conv_state, h_last


def mamba_forward(params, x: torch.Tensor, *, chunk: int = 64, state=None,
                  return_state: bool = False, use_kernel: bool = False):
    """x (B, S, d_model) -> (B, S, d_model); with ``return_state`` also the
    layer's new {conv, ssm} state.  The kernel runs only from a zero state
    (prefill)."""
    x = shard(x, "dp", None, None)
    xz = shard(x @ params["w_in"], "dp", None, "tp")
    B = x.shape[0]
    d_inner = params["conv_w"].shape[1]
    d_state = params["A_log"].shape[1]
    if state is None:
        conv_state = None
        h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
    else:
        conv_state, h0 = state["conv"], state["ssm"]
    y, conv_state, h_last = _ssm_inner(params, xz, conv_state, h0, chunk,
                                       use_kernel=use_kernel and state is None)
    out = shard(y @ params["w_out"], "dp", "sp", None)
    if return_state:
        return out, {"conv": conv_state.to(torch.bfloat16), "ssm": h_last}
    return out


def mamba_decode_step(params, x: torch.Tensor, state):
    """x (B, 1, d_model); state {conv (B, dconv-1, d_inner), ssm (B, d, s)}."""
    return mamba_forward(params, x, chunk=1, state=state, return_state=True)
