"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-3B]."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, heads=24, kv_heads=8, d_ff=8192,
    vocab=128256, rope_theta=5e5, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama3.2-3b-smoke",
    num_layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128, vocab=128,
)
