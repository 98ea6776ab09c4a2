"""whisper-large-v3 [audio]: 32L(+32L enc) d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866 — enc-dec, conv frontend stub [arXiv:2212.04356]."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="whisper", max_positions=32768,
    num_layers=32, enc_layers=32, d_model=1280, heads=20, kv_heads=20,
    d_ff=5120, vocab=51866, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke",
    num_layers=2, enc_layers=2, d_model=64, heads=4, kv_heads=4,
    d_ff=128, vocab=128,
)
