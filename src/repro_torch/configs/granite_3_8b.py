"""Granite-3.0-8B [hf:ibm-granite/granite-3.0-2b-base family; hf].

40 layers, d_model 4096, GQA 32H/8KV (d_head 128), d_ff 12800, vocab 49155.
Note: vocab 49155 is not divisible by the 16-wide tp axis; the lm_head
shards skip vocab partitioning (see distributed.sharding.shard) and the CE
loss_chunk is reduced to bound the replicated logits tile.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12800,
    vocab=49155,
    pattern=(("attn", "mlp"),),
    rope_theta=1e6,
    tie_embeddings=False,
    loss_chunk=128,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="granite-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=515,  # deliberately non-divisible, like the full config
    q_chunk=16,
    kv_chunk=32,
    loss_chunk=32,
    tp_pad=1,
)
