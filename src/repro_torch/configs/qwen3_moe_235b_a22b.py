"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf].

94 layers, d_model 4096, GQA 64H/4KV (d_head 128), qk-norm, 128 experts
top-8 (expert d_ff 1536), no shared expert, vocab 151936.
"""
import dataclasses

from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    pattern=(("attn", "moe"),),
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert_ff=1536),
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=96, capacity_factor=4.0),
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
