"""Mamba-1 block (as used by Jamba) with a chunked selective scan.

Selective SSM recurrence per channel d and state s:
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D x_t
From a zero state with ``use_kernel`` (prefill), the scan runs through the
selective-scan kernel (``ops.mamba_scan``), which folds ``D`` in.  Otherwise,
and always from a carried state (decode), the sequence is processed in
chunks: within a chunk the (decay, update) pairs are scanned step by step
(``kernels.ref.linear_scan``), chunks chained by a Python loop carrying the
(d_inner, d_state) state, and ``D x`` is added after.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import linear_scan, scan_chunk
from repro_torch.models.layers import normal

__all__ = ["init_mamba", "mamba_forward", "mamba_decode_step",
           "mamba_state_shapes"]


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


def _ssm_inner(params, xz: torch.Tensor, conv_state, h0, chunk: int,
               use_kernel: bool = False):
    """Everything after in_proj: xz (B, S, 2*d_inner) -> (y, conv state,
    final ssm state).  The kernel route folds ``D`` into the kernel; the
    chunked route adds it after the scan."""
    x, z = xz.chunk(2, dim=-1)
    x, conv_state = _conv1d(x, params["conv_w"], params["conv_b"], conv_state)
    x = F.silu(x.float()).to(x.dtype)
    proj = x @ params["w_x"]                                 # (B, S, dt_rank + 2*s)
    d_state = params["A_log"].shape[1]
    dt_rank = proj.shape[-1] - 2 * d_state
    dt_raw, Bm, Cm = proj.split([dt_rank, d_state, d_state], dim=-1)
    if use_kernel:
        dt = _softplus((dt_raw @ params["w_dt"]).float() + params["dt_bias"])
        y, h_last, _ = ops.mamba_scan(dt, x.float(), Bm.float(), Cm.float(),
                                      params["A_log"], params["D"])
    else:
        y, h_last = _ssm_scan_chunked(params, dt_raw, Bm, Cm, x, h0, chunk)
        y = y + params["D"][None, None] * x.float()
    y = y * F.silu(z.float())
    return y.to(xz.dtype), conv_state, h_last


def mamba_forward(params, x: torch.Tensor, *, chunk: int = 64, state=None,
                  return_state: bool = False, use_kernel: bool = False):
    """x (B, S, d_model) -> (B, S, d_model); with ``return_state`` also the
    layer's new {conv, ssm} state.  The kernel runs only from a zero state
    (prefill)."""
    xz = x @ params["w_in"]
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
    out = y @ params["w_out"]
    if return_state:
        return out, {"conv": conv_state.to(torch.bfloat16), "ssm": h_last}
    return out


def mamba_decode_step(params, x: torch.Tensor, state):
    """x (B, 1, d_model); state {conv (B, dconv-1, d_inner), ssm (B, d, s)}."""
    return mamba_forward(params, x, chunk=1, state=state, return_state=True)
