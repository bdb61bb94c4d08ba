"""Gemma-3-12B [hf:google/gemma-3-1b-pt family; unverified].

48 layers in a 5:1 local(sliding-window 1024):global pattern, d_model 3840,
GQA 16H/8KV (d_head 256), qk-norm, d_ff 15360, vocab 262144, 128k context.
Sub-quadratic eligible: 40/48 layers are windowed; the 8 global layers use
a sequence-sharded KV cache at 500k (DESIGN.md Sec. 8).
"""
import dataclasses

from repro_torch.models import ModelConfig

_PATTERN = tuple(
    ("attn_local" if i < 5 else "attn", "mlp") for i in range(6)
)

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab=262144,
    pattern=_PATTERN,
    window=1024,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="gemma3-smoke",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    window=16,
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
