"""The token stream of a training mix, made from the seed.

Ids are drawn over the model's whole vocabulary by a Zipf law (rank r has
weight r^-s, as words in text), the ranks mapped onto ids by a permutation
drawn from the seed.  Documents of heavy-tailed lengths (log-normal, cut to
[min, max]) end with ``eos_id`` and are packed back to back; each row is the
next ``seq_len + 1`` tokens of that stream, so documents run across rows as
packing makes them.  A step is ``microbatches * rows`` rows; the mix holds
``pool_steps`` distinct steps, which the window cycles through.

The traffic file's keys: ``seq_len``, ``rows`` (sequences a microbatch),
``microbatches``, ``pool_steps``, ``zipf_s``, ``eos_id`` and ``doc_len``
(``median``, ``sigma``, ``min``, ``max``).  Every seed gives the same
shapes; only the ids differ.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

STREAM = 1  # the purpose index of the token stream in the seed's SeedSequence


def rows_per_step(traffic: Dict[str, Any]) -> int:
    return int(traffic["microbatches"]) * int(traffic["rows"])


def tokens_per_step(traffic: Dict[str, Any]) -> int:
    return rows_per_step(traffic) * int(traffic["seq_len"])


def _zipf_cdf(vocab: int, s: float) -> np.ndarray:
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(s)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def stream(traffic: Dict[str, Any], vocab: int, seed: int, steps: int) -> np.ndarray:
    """(steps, rows_per_step, seq_len + 1) int64 ids in [0, vocab)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), STREAM]))
    n_rows = steps * rows_per_step(traffic)
    width = int(traffic["seq_len"]) + 1
    need = n_rows * width
    doc = traffic["doc_len"]
    eos = int(traffic["eos_id"])
    rank_to_id = rng.permutation(vocab)
    cdf = _zipf_cdf(vocab, traffic["zipf_s"])
    words = rank_to_id[np.searchsorted(cdf, rng.random(need), side="right").clip(0, vocab - 1)]
    # document ends: lengths from a log-normal law, each document closed by eos
    mean = float(doc["median"]) * np.exp(float(doc["sigma"]) ** 2 / 2)
    lengths = np.exp(rng.normal(np.log(float(doc["median"])), float(doc["sigma"]),
                                int(need / mean * 2) + 16))
    lengths = lengths.clip(int(doc["min"]), int(doc["max"])).astype(np.int64)
    ends = np.cumsum(lengths)
    ends = ends[ends < need]
    words[ends] = eos
    return words.reshape(steps, rows_per_step(traffic), width)


def step_batch(rows: np.ndarray) -> Dict[str, np.ndarray]:
    """One step's batch from its (rows, seq_len + 1) ids: each position's
    next token is its target."""
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
