"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf].

28 layers, d_model 1024, GQA 16H/8KV with head_dim 128 (Qwen3 decouples
head_dim from d_model), qk-norm, d_ff 3072, vocab 151936, tied embeddings.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab=151936,
    pattern=(("attn", "mlp"),),
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen3-0.6b-smoke",
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
