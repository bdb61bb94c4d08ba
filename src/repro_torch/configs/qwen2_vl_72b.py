"""Qwen2-VL-72B [arXiv:2409.12191; hf].

80-layer backbone, d_model 8192, GQA 64H/8KV (d_head 128), d_ff 29568,
vocab 152064, M-RoPE (sections 16/24/24 over t/h/w position ids).  The
vision frontend (dynamic-resolution ViT) is a STUB per the assignment:
input_specs provides precomputed patch/text embeddings plus 3-axis
position ids.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    pattern=(("attn", "mlp"),),
    pos="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    qkv_bias=True,
    input_mode="embeds",
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen2-vl-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    mrope_sections=(4, 2, 2),
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
