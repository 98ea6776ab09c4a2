"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191].
Vision frontend is a stub: input_specs() provides patch/text embeddings
plus (3, B, S) M-RoPE position ids."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, heads=12, kv_heads=2, d_ff=8960,
    vocab=151936, rope_theta=1e6, tie_embeddings=True,
    mrope_sections=(16, 24, 24),  # sums to head_dim/2 = 64
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-vl-smoke",
    num_layers=2, d_model=64, heads=4, kv_heads=2, d_ff=96, vocab=128,
    mrope_sections=(2, 3, 3),  # head_dim 16 -> half 8
)
