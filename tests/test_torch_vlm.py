"""The vlm family (qwen2-vl, M-RoPE) in the port against the JAX package:
``apply_mrope`` at qwen2-vl-2b's sections (16, 24, 24) and the smoke
config's (2, 3, 3); M-RoPE with three equal streams is 1-D RoPE; the smoke
model's forward with ``embeds`` and ``positions3`` and its decode with
``positions3``; and ``serve_waves`` with prompts of embeddings."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    BatchScheduler, Request, make_serve_step, serve_waves,
)

ARCH = "qwen2-vl-2b"
# the dense family's tolerance (tests/test_torch_transformer.py)
F32 = dict(atol=1e-4, rtol=1e-4)


def _grid3(B, S, side, seed=0):
    """positions3 (3, B, S): a side x side patch grid (0, row, col), then
    text continuing at side in all three streams, shifted per row of B."""
    rng = np.random.RandomState(seed)
    n = min(S, side * side)
    p = np.zeros((3, B, S), np.int32)
    for b in range(B):
        off = rng.randint(0, 4)
        p[1, b, :n] = np.arange(n) // side + off
        p[2, b, :n] = np.arange(n) % side + off
        p[:, b, n:] = side + off + np.arange(S - n)
    return p


@pytest.mark.parametrize("sections, dh, theta", [((16, 24, 24), 128, 1e6), ((2, 3, 3), 16, 1e6),
                                                 ((2, 3, 3), 16, 1e4)])
def test_apply_mrope_matches_jax(sections, dh, theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 24, 3, dh).astype(np.float32)
    pos3 = _grid3(2, 24, 4)
    want = JC.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections, theta)
    got = C.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_mrope_with_equal_streams_is_rope():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 10, 4, 128).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 5000, (2, 10)))
    got = C.apply_mrope(x, pos[None].expand(3, -1, -1), (16, 24, 24), 1e6)
    assert torch.equal(got, C.apply_rope(x, pos, 1e6))


def test_mrope_refuses_sections_that_do_not_fill_half_the_head():
    with pytest.raises(ValueError, match="sections"):
        C.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2, dtype=torch.long), (2, 3, 2))
    assert sum(get_config(ARCH).mrope_sections) == get_config(ARCH).resolved_head_dim // 2


@functools.lru_cache(maxsize=None)
def _jax():
    zoo = jax_get_model(jax_smoke(ARCH))
    return zoo, jax.jit(zoo.forward), jax.jit(zoo.decode_step), zoo.init(jax.random.PRNGKey(0))


def _port(attn_impl="ref"):
    zoo = get_model(dataclasses.replace(get_smoke_config(ARCH), attn_impl=attn_impl))
    np_tree = jax.tree_util.tree_map(np.asarray, _jax()[3])
    return zoo, ParamTree.from_state_dict(params_from_jax(np_tree, dtype="float32", device="cpu"))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_forward_with_embeds_and_positions3_matches_jax(attn_impl):
    _, jfwd, _, jp = _jax()
    zoo, tp = _port(attn_impl)
    emb = np.random.RandomState(3).randn(2, 20, 64).astype(np.float32)
    pos3 = _grid3(2, 20, 4, seed=1)
    want, _ = jfwd(jp, {"embeds": jnp.asarray(emb), "positions3": jnp.asarray(pos3)})
    got, _ = zoo.forward(tp, {"embeds": torch.from_numpy(emb),
                              "positions3": torch.from_numpy(pos3)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    # the streams matter: 1-D positions give other logits
    flat, _ = zoo.forward(tp, {"embeds": torch.from_numpy(emb)})
    assert (flat - got).abs().max() > 1e-3


def test_forward_with_tokens_matches_jax():
    _, jfwd, _, jp = _jax()
    zoo, tp = _port("flash")
    toks = np.random.RandomState(4).randint(0, 128, (2, 12)).astype(np.int32)
    pos3 = _grid3(2, 12, 3, seed=2)
    want, _ = jfwd(jp, {"tokens": jnp.asarray(toks), "positions3": jnp.asarray(pos3)})
    got, _ = zoo.forward(tp, {"tokens": torch.from_numpy(toks).long(),
                              "positions3": torch.from_numpy(pos3)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_decode_with_positions3_matches_jax():
    """A fill of embeddings with their grid positions, then token steps with
    positions3 continuing after the grid: logits and cache."""
    jzoo, _, jdec, jp = _jax()
    zoo, tp = _port()
    emb = np.random.RandomState(5).randn(2, 9, 64).astype(np.float32)
    pos3 = _grid3(2, 9, 3, seed=3)
    jc, tc = jzoo.init_cache(2, 14), zoo.init_cache(2, 14, device="cpu")
    want, jc = jdec(jp, jc, {"embeds": jnp.asarray(emb), "positions3": jnp.asarray(pos3)})
    got, tc = zoo.decode_step(tp, tc, {"embeds": torch.from_numpy(emb),
                                       "positions3": torch.from_numpy(pos3)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    toks = np.random.RandomState(6).randint(0, 128, (2, 3)).astype(np.int32)
    for t in range(3):
        p = np.broadcast_to(pos3.max(axis=(0, 2))[None, :, None] + 1 + t, (3, 2, 1)).copy()
        want, jc = jdec(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                 "positions3": jnp.asarray(p)})
        got, tc = zoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
                                           "positions3": torch.from_numpy(p)})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **F32)


def test_serve_waves_with_embeds_and_positions3():
    """Prompts of embeddings with grid positions: the prefill (flash path)
    and the one-call fill give the same last logits, every request is
    answered, and each decode step's positions3 is the prompt's largest
    position + 1 + step in all three streams."""
    zoo, tp = _port("flash")
    arts = make_serve_step(zoo, device="cpu")
    seen = []

    def decode_fn(p, cache, batch):
        if "positions3" in batch and batch["positions3"].shape[2] == 1:
            seen.append(batch["positions3"][:, :, 0].clone())
        return arts.decode_fn(p, cache, batch)

    sched = BatchScheduler(slots=2, eos_id=-1)
    rng = np.random.RandomState(7)
    pos3 = _grid3(2, 16, 4, seed=4)
    reqs = [Request(rid=i, prompt=rng.randn(16, 64).astype(np.float32), max_new=4,
                    positions3=pos3[:, i]) for i in range(2)]
    for r in reqs:
        sched.submit(r)
    waves = serve_waves(zoo, dataclasses.replace(arts, decode_fn=decode_fn), tp, sched, 20,
                        device="cpu")
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    w = waves[0]
    np.testing.assert_allclose(_np(w.prefill_last), _np(w.fill_last), **F32)
    want = [torch.from_numpy(pos3.max(axis=(0, 2)) + 1 + s)[None].expand(3, 2) for s in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(seen, want))
    assert len(seen) == w.decode_steps == 3
