"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, heads=32, kv_heads=8, d_ff=12288,
    vocab=151936, qk_norm=True, rope_theta=1e6, tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-8b-smoke",
    num_layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128, vocab=128,
)
