"""The port's zamba2 hybrid (repro_torch.models.hybrid) against
repro.models.hybrid on the zamba2-smoke config (f32, CPU): params, forward,
cache, token-by-token decode, greedy serving, and a bf16 cache carried to
JAX and back."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_jax, torch_dtype  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    BatchScheduler, Request, make_serve_step, serve_waves,
)

ARCH = "zamba2-7b"
# f32 on both sides: XLA and torch differ in sum order and libm only; 1e-4
# as test_model_ssm_equivalences (tests/test_kernels.py)
F32 = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax():
    zoo = jax_get_model(jax_smoke(ARCH))
    params = jax.jit(zoo.init)(jax.random.PRNGKey(0))
    return zoo, params, jax.jit(zoo.forward), jax.jit(zoo.decode_step)


def _port():
    _, jp, _, _ = _jax()
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), dtype="float32", device="cpu")
    return get_model(get_smoke_config(ARCH)), ParamTree.from_state_dict(sd)


def _tokens(S, B=2, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _flat(tree):
    return {".".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_param_tree_matches_jax():
    _, jp, _, _ = _jax()
    zoo, _ = _port()
    jshapes = {k: v.shape for k, v in _flat(jp).items()}
    tshapes = {k: tuple(v.shape) for k, v in zoo.init(0, device="cpu").state_dict().items()}
    assert tshapes == jshapes
    # 8 layers in groups of 3: two groups of (2, 3, ...) leaves and a tail of 2
    assert jshapes["groups.mix.in_proj.w"][:2] == (2, 3) and jshapes["tail.ln.scale"][0] == 2


@pytest.mark.parametrize("S", [20, 70])  # one chunk; two chunks of 64 with a padded tail
def test_forward_matches_jax(S):
    _, jp, jfwd, _ = _jax()
    zoo, tp = _port()
    toks = _tokens(S)
    want, _ = jfwd(jp, {"tokens": jnp.asarray(toks)})
    before = fa.launch_counts()
    got, aux = zoo.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, S, 128) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert fa.launch_counts() == before and ssd_mod.LAUNCHES == 0  # the CPU runs no kernel


def test_init_cache_matches_jax():
    jzoo, _, _, _ = _jax()
    zoo, _ = _port()
    want, got = jzoo.init_cache(2, 12), zoo.init_cache(2, 12, device="cpu")
    assert got["index"] == int(want["index"]) == 0
    pairs = [(got[a][b], want[a][b]) for a in ("mamba", "tail") for b in ("conv", "ssm")]
    pairs += [(got[k], want[k]) for k in ("attn_k", "attn_v")]
    for g, w in pairs:
        assert g.dtype is torch_dtype(w.dtype) and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_decode_steps_match_jax():
    """Token-by-token decode: logits each step, then the whole cache."""
    jzoo, jp, _, jdec = _jax()
    zoo, tp = _port()
    toks = _tokens(6, seed=2)
    jc, tc = jzoo.init_cache(2, 8), zoo.init_cache(2, 8, device="cpu")
    for t in range(6):
        want, jc = jdec(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, tc = zoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert tc["index"] == int(jc["index"]) == 6
    for part, leaf in (("mamba", "conv"), ("mamba", "ssm"), ("tail", "conv"), ("tail", "ssm")):
        np.testing.assert_allclose(_np(tc[part][leaf]), np.asarray(jc[part][leaf]), **F32)
    for leaf in ("attn_k", "attn_v"):
        np.testing.assert_allclose(_np(tc[leaf]), np.asarray(jc[leaf]), **F32)


def test_decode_step_takes_one_token_per_call():
    zoo, tp = _port()
    assert zoo.decode_tokens == 1
    with pytest.raises(ValueError, match="one token per call"):
        zoo.decode_step(tp, zoo.init_cache(2, 8, device="cpu"),
                        {"tokens": torch.from_numpy(_tokens(4)).long()})


def test_prefill_matches_token_by_token_fill():
    """The chunked scan (prefill) against the recurrence (decode), the check
    chip_smoke.py makes at full size."""
    zoo, tp = _port()
    toks = torch.from_numpy(_tokens(24, B=1, seed=3)).long()
    logits, _ = zoo.forward(tp, {"tokens": toks})
    cache, outs = zoo.init_cache(1, 24, device="cpu"), []
    for t in range(24):
        lg, cache = zoo.decode_step(tp, cache, {"tokens": toks[:, t:t + 1]})
        outs.append(lg)
    # f32; the two forms sum in other orders (chunk products vs a 24-step
    # recurrence through 8 layers)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(logits), atol=1e-3, rtol=1e-3)


def test_wave_server_answers_with_jax_greedy_tokens():
    jzoo, jp, jfwd, jdec = _jax()
    zoo, tp = _port()
    rng = np.random.RandomState(4)
    reqs = [Request(rid=i, prompt=rng.randint(2, 128, 6), max_new=4) for i in range(3)]
    sched = BatchScheduler(slots=2, eos_id=-1)
    for r in reqs:
        sched.submit(r)
    waves = serve_waves(zoo, make_serve_step(zoo, device="cpu"), tp, sched, 10, device="cpu")
    assert [len(w.requests) for w in waves] == [2, 1] and sched.idle
    for w in waves:
        # prefill (chunked scan) vs the token-by-token fill (recurrence), f32
        torch.testing.assert_close(w.prefill_last, w.fill_last, atol=1e-4, rtol=1e-4)
        assert w.decode_steps == 3
    # JAX: forward for the first token, the prompt fed token by token, then steps
    for r in reqs:
        toks = jnp.asarray(r.prompt[None], jnp.int32)
        logits, _ = jfwd(jp, {"tokens": toks})
        out = [int(jnp.argmax(logits[0, -1]))]
        cache = jzoo.init_cache(1, 10)
        for t in range(toks.shape[1]):
            _, cache = jdec(jp, cache, {"tokens": toks[:, t:t + 1]})
        for _ in range(3):
            lg, cache = jdec(jp, cache, {"tokens": jnp.asarray([[out[-1]]], jnp.int32)})
            out.append(int(jnp.argmax(lg[0, -1])))
        assert r.generated == out, r.rid


def test_bf16_cache_crosses_to_jax_and_back():
    """A bf16 hybrid cache holds a bf16 conv state and KV beside an f32 SSM
    state: params_from_jax(dtype=None) keeps each leaf's dtype."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    rng = np.random.RandomState(5)
    # the reference's cache, its leaves filled with random values of their dtype
    jc = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.randn(*a.shape), a.dtype) if a.ndim else np.asarray(3, a.dtype),
        jax_get_model(jcfg).init_cache(2, 8))
    sd = params_from_jax(jc, dtype=None, device="cpu")
    assert sd["mamba.conv"].dtype == sd["attn_k"].dtype == torch.bfloat16
    assert sd["mamba.ssm"].dtype == sd["tail.ssm"].dtype == torch.float32
    assert sd["index"] == 3
    back = _flat(params_to_jax(sd))
    for k, v in _flat(jc).items():
        np.testing.assert_array_equal(back[k], v)


def test_param_count_is_the_references():
    """A reference quirk, kept: ``ModelConfig.param_count`` counts a SwiGLU
    in each of zamba2-7b's 81 layers, where only the shared block has one,
    so it gives 18.9 B against the leaves' 6.66 B (MFU is reported on the
    leaves)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    full = get_config(ARCH)
    assert full.param_count() == jax_config(ARCH).param_count() == 18_912_452_608
    leaves = sum(int(np.prod(s)) for s in get_model(full).param_shapes().values())
    assert leaves == 6_662_132_944
