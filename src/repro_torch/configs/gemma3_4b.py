"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-4b-pt]."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, heads=8, kv_heads=4, d_ff=10240,
    vocab=262144, qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    sliding_window=1024, global_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-4b-smoke",
    num_layers=6, d_model=64, heads=4, kv_heads=2, d_ff=128, vocab=128,
    sliding_window=8, global_every=3,
)
