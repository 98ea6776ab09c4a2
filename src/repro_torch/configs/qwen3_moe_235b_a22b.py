"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B]."""

import dataclasses
from .base import ModelConfig, MoEParams

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, heads=64, kv_heads=4, d_ff=1536,
    vocab=151936, qk_norm=True, rope_theta=1e6, tie_embeddings=False,
    moe=MoEParams(num_experts=128, top_k=8, d_ff=1536),
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-moe-smoke",
    num_layers=2, d_model=64, heads=4, kv_heads=2, d_ff=96, vocab=128,
    moe=MoEParams(num_experts=4, top_k=2, d_ff=96),
)
