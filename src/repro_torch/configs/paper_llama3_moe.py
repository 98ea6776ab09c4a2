"""The paper's own traced workload (SA.4 Listing 1): Llama3-70B-arch with
an 8-expert top-2 MoE FFN; used by the mapping/scheduling benchmarks and
the end-to-end example at reduced scale."""

import dataclasses
from .base import ModelConfig, MoEParams

CONFIG = ModelConfig(
    name="paper-llama3-moe", family="moe",
    num_layers=80, d_model=8192, heads=64, kv_heads=8, d_ff=28672,
    vocab=128256, rope_theta=5e5, tie_embeddings=False,
    moe=MoEParams(num_experts=8, top_k=2, d_ff=28672, aux_loss_coeff=0.01),
)

SMOKE = dataclasses.replace(
    CONFIG, name="paper-llama3-moe-smoke",
    num_layers=2, d_model=64, heads=4, kv_heads=2, d_ff=96, vocab=128,
    moe=MoEParams(num_experts=4, top_k=2, d_ff=96),
)
