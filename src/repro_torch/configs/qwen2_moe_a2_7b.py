"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24 layers, d_model 2048, MHA 16H/16KV (d_head 128), QKV bias, 60 routed
experts top-4 (expert d_ff 1408) + shared expert of 4x width (5632),
vocab 151936.
"""
import dataclasses

from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=151936,
    pattern=(("attn", "moe"),),
    qkv_bias=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert_ff=1408, n_shared=4),
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen2-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=96,
    vocab=512,
    moe=MoEConfig(n_experts=6, top_k=2, d_expert_ff=96, n_shared=2,
                  capacity_factor=4.0),
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
