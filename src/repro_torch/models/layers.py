"""Shared model layers: RMS norms, rotary positions, the embedding and the
MLPs.

Pure-function style as in the reference package: ``init_*`` returns a dict of
tensors, the apply functions take (params, x).  Every ``init_*`` takes an
explicit ``torch.Generator`` and device.  Multimodal rope and sinusoidal
positions wait for their architectures (ROADMAP.md queue 1, item 8.4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["normal", "init_rmsnorm", "rmsnorm", "rms_head_norm", "rope_freqs",
           "rope_cos_sin", "apply_rope", "init_mlp", "apply_mlp",
           "init_embedding", "embed"]


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
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """Per-head RMS norm (qk-norm): x (..., hd), scale (hd,)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
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
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


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


def apply_mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  ``gelu`` is the tanh form, as
    ``jax.nn.gelu`` computes it by default."""
    up = x @ params["w_up"]
    if act == "swiglu":
        gate = x @ params["w_gate"]
        h = F.silu(gate.float()).to(x.dtype) * up
    elif act == "gelu":
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# embedding


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16):
    return {"table": normal(gen, (vocab, d), dtype, 0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d)."""
    return params["table"][tokens]
