"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887; hf].

72 layers of 9x (1 attention : 7 Mamba) blocks; MoE (16 experts, top-2) on
every other layer.  No explicit positional embedding (Mamba provides
position).  GQA 64H/8KV, d_head 128.
"""
import dataclasses

from repro_torch.models import ModelConfig, MoEConfig

_PATTERN = tuple(
    ("attn" if i == 0 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    pattern=_PATTERN,
    pos="none",
    moe=MoEConfig(n_experts=16, top_k=2, d_expert_ff=24576),
    mamba_d_state=16,
    mamba_expand=2,
    mamba_dconv=4,
    tie_embeddings=False,
    sub_quadratic=True,   # hybrid: eligible for long_500k
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="jamba-smoke",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert_ff=128, capacity_factor=4.0),
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
