"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 -- sLSTM + mLSTM
blocks [arXiv:2405.04517].  d_ff=0: blocks are pure mLSTM/sLSTM (no FFN);
every 4th block is sLSTM."""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, heads=4, kv_heads=4, d_ff=0, vocab=50304,
    xlstm_slstm_every=4, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-125m-smoke",
    num_layers=4, d_model=64, heads=2, vocab=128,
)
