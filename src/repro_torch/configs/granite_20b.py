"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324]."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, heads=48, kv_heads=1, d_ff=24576,
    vocab=49152, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-20b-smoke",
    num_layers=2, d_model=64, heads=4, kv_heads=1, d_ff=128, vocab=128,
)
