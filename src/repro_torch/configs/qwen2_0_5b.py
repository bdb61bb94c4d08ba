"""Qwen2-0.5B [arXiv:2407.10671; hf].

24 layers, d_model 896, GQA 14H/2KV (d_head 64), QKV bias, d_ff 4864,
vocab 151936, tied embeddings.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab=151936,
    pattern=(("attn", "mlp"),),
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen2-0.5b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
