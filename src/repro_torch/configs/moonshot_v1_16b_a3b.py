"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B]."""

import dataclasses
from .base import ModelConfig, MoEParams

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, heads=16, kv_heads=16, d_ff=1408,
    vocab=163840, rope_theta=5e4, tie_embeddings=False,
    moe=MoEParams(num_experts=64, top_k=6, d_ff=1408),
)

SMOKE = dataclasses.replace(
    CONFIG, name="moonshot-smoke",
    num_layers=2, d_model=64, heads=4, kv_heads=4, d_ff=96, vocab=128,
    moe=MoEParams(num_experts=4, top_k=2, d_ff=96),
)
