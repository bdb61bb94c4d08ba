"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf].

32 layers, d_model 2560 (attention-free), head_dim 64 (40 wkv heads, padded
to 48 so the 16-wide tp axis divides), channel-mix d_ff 8960, vocab 65536.
Data-dependent decay via LoRA (the Finch hallmark).
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,        # informational: wkv heads = d_model / rwkv_head_dim
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab=65536,
    pattern=(("rwkv", "rwkv_cmix"),),
    pos="none",
    rwkv_head_dim=64,
    tp_pad=16,         # pads wkv heads 40 -> 48 for tp=16
    tie_embeddings=False,
    sub_quadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="rwkv6-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    rwkv_head_dim=16,
    tp_pad=1,
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
)
