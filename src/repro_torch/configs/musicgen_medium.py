"""MusicGen-medium [arXiv:2306.05284; hf].

48-layer decoder-only transformer over EnCodec tokens: d_model 1536, MHA
24H/24KV (d_head 64), GELU d_ff 6144, vocab 2048 (codebook size),
sinusoidal positions.  The EnCodec frontend is a STUB per the assignment:
input_specs provides precomputed frame embeddings (B, S, d_model).
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab=2048,
    pattern=(("attn", "mlp"),),
    act="gelu",
    pos="sinusoidal",
    input_mode="embeds",
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="musicgen-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=128,
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
