"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336
ssm_state=64 -- Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242]."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, heads=32, kv_heads=32, d_ff=14336,
    vocab=32000, ssm_state=64, shared_attn_every=6, mamba_head_dim=64,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke",
    num_layers=8, d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=128,
    ssm_state=16, shared_attn_every=3, mamba_head_dim=16,
)
