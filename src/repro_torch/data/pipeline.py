"""Deterministic synthetic LM data pipeline (the port's own copy of
``repro/data/pipeline.py``, in numpy only).

A fixed random bigram transition table generates sequences with learnable
structure, so training shows a real loss drop.  Generation is counter-based
(a seed made of (seed, step, shard)), so any host can make exactly its shard
for any step: restart-safe, with no data state to checkpoint beyond the
step counter.  Batches are bit-identical to the reference's for every
(step, shard).

The table is ``vocab x vocab`` float64: 131 GB at llama3.2-3b's 128256, as in
the reference.  A full-width run draws its tokens from a smaller vocabulary
(any ``vocab`` up to the model's gives valid ids).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    bigram_temp: float = 1.2


def _bigram_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.RandomState(cfg.seed)
    logits = rng.randn(cfg.vocab, cfg.vocab) * cfg.bigram_temp
    # sparsify: each token strongly prefers ~8 successors
    top = np.argsort(-logits, axis=1)[:, :8]
    boost = np.zeros_like(logits)
    np.put_along_axis(boost, top, 4.0, axis=1)
    p = np.exp(logits * 0.1 + boost)
    return p / p.sum(axis=1, keepdims=True)


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.table = _bigram_table(cfg)
        self.cum = np.cumsum(self.table, axis=1)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, shard): tokens + next-token targets."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        bs = cfg.global_batch // num_shards
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 9176 + shard * 31) % (2 ** 31)
        )
        seq = np.empty((bs, cfg.seq_len + 1), np.int32)
        seq[:, 0] = rng.randint(0, cfg.vocab, bs)
        u = rng.rand(bs, cfg.seq_len)
        for t in range(cfg.seq_len):
            # inverse-CDF sample from the bigram row of the previous token
            rows = self.cum[seq[:, t]]
            seq[:, t + 1] = (u[:, t : t + 1] < rows).argmax(axis=1)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def batches(self, start_step: int = 0, shard: int = 0,
                num_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, shard, num_shards)
            step += 1


def optimal_nll(cfg: DataConfig) -> float:
    """Entropy rate of the bigram chain: the loss floor a perfect model
    reaches."""
    table = _bigram_table(cfg)
    # stationary distribution via power iteration
    pi = np.ones(cfg.vocab) / cfg.vocab
    for _ in range(200):
        pi = pi @ table
    h = -np.sum(pi[:, None] * table * np.log(np.maximum(table, 1e-12)))
    return float(h)
