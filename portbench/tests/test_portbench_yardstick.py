"""The yardstick's own pieces: the token stream, the operation and byte
counts, the weights."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench_cells import SMOKE_MODELS

from portbench import bench, counts, tokens, weights
from portbench.reference import decoder_lm


def _mix():
    return bench.load_json(bench.HERE / "traffic" / "pretrain-8k.json")


def test_the_token_stream_repeats_per_seed_and_differs_across_seeds():
    mix = dict(_mix(), seq_len=512, pool_steps=3)
    a = tokens.stream(mix, 163840, 2 ** 31 + 17, 3)
    b = tokens.stream(mix, 163840, 2 ** 31 + 17, 3)
    c = tokens.stream(mix, 163840, 2 ** 31 + 18, 3)
    assert a.shape == (3, 2, 513) and a.dtype == np.int64
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 163840
    batch = tokens.step_batch(a[0])
    assert np.array_equal(batch["tokens"][:, 1:], batch["targets"][:, :-1])


def test_the_token_stream_is_zipf_over_the_whole_vocabulary_with_documents():
    mix = dict(_mix(), seq_len=8192, pool_steps=4)
    ids = tokens.stream(mix, 163840, 3, 4).reshape(-1)
    _, n = np.unique(ids, return_counts=True)
    share = np.sort(n)[::-1] / ids.size
    assert share[0] > 0.05 and share[:10].sum() > 0.2        # a few ids carry much of the text
    assert len(n) > 5000 and ids.max() > 100000               # and the tail reaches the whole table
    ends = np.flatnonzero(ids == mix["eos_id"])
    assert 10 < len(ends) < ids.size // mix["doc_len"]["min"]


def test_flash_bounds_match_hand_counts_at_one_shape():
    B, H, Hk, S, Dh = 1, 16, 16, 8192, 128
    pairs = S * (S + 1) // 2
    flops_fwd = 4 * Dh * pairs * B * H
    q = B * H * S * Dh * 2
    kv = 2 * B * Hk * S * Dh * 2
    rows = B * H * S * 4
    assert counts.flash_bound_s("flash_fwd_lse", B, H, Hk, S, S, Dh, "bfloat16") == pytest.approx(
        max(flops_fwd / 989e12, (kv + 2 * q + rows) / 3.35e12))
    assert counts.flash_bound_s("flash_bwd_dkv", B, H, Hk, S, S, Dh, "bfloat16") == pytest.approx(
        max(2 * flops_fwd / 989e12, (kv + 2 * q + 2 * rows + kv) / 3.35e12))
    assert counts.visible_pairs(64, 64, True, None, 0) == (64 * 65 // 2, 64)
    assert counts.visible_pairs(4, 10, True, 2, 6) == (8, 5)


def test_model_operations_count_the_matmul_active_parameters():
    m = bench.load_json(bench.HERE / "configs" / "moonshot-v1-16b-a3b-l4.json")["model"]
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + (6 + 2) * 3 * 2048 * 1408  # top-6 and 2 shared
    assert counts.matmul_active_params(m) == 4 * per_layer + 2048 * 163840
    assert counts.matmul_active_params(m) == pytest.approx(0.680e9, rel=2e-3)
    attn = 6 * 4 * 16 * 128 * 8192 ** 2
    assert counts.train_step_flops(m, 2, 8192) == 6 * counts.matmul_active_params(m) * 16384 \
        + 2 * attn


def test_weights_are_made_again_leaf_by_leaf_bit_for_bit():
    m = dict(SMOKE_MODELS["qwen3-8b"], d_ff=96, vocab=256)
    layout = decoder_lm.param_layout(m)
    w = weights.make(layout, 2 ** 33 + 5, torch.bfloat16, "cpu")
    again = weights.make_leaf(layout, "layers.attn.wk.w", 2 ** 33 + 5, torch.bfloat16, "cpu")
    assert torch.equal(w["layers.attn.wk.w"], again)
    assert w["layers.attn.wk.w"].abs().max() <= 2 * 64 ** -0.5 * 1.01
    assert not torch.equal(w["layers.attn.wq.w"][0, :, :32], w["layers.attn.wk.w"][0])
    assert torch.equal(w["layers.ln1.scale"], torch.ones(2, 64, dtype=torch.bfloat16))


@pytest.mark.parametrize("which", ["moonshot-v1-16b-a3b", "qwen3-8b",
                                   *(c["name"] for c in bench.load_json(
                                       bench.ROOT / "BENCHMARK.json")["configs"])])
def test_the_reference_names_and_shapes_the_ports_parameters(which):
    """The weights the benchmark makes are the tree the port's model takes,
    for the tiny models and for each configuration of a cell (the runner
    does not ask the port on the card: its meta init costs seconds of
    set-up)."""
    from portbench_cells import cell

    from repro_torch.models.model_zoo import get_model

    path = bench.HERE / "configs" / f"{which}.json"
    c = (bench.Cell(which, 1, bench.load_json(path), {}, {}, [], [])
         if path.exists() else cell(which))
    layout = decoder_lm.param_layout(c.config["model"])
    zoo = get_model(bench.runner("train").program_config(c))
    assert zoo.param_shapes() == {k: tuple(v[0]) for k, v in layout.items()}
