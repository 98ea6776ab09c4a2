"""whisper in the port (``models/whisper.py``) against the JAX package:
``layernorm``, ``gelu_mlp`` (tanh GELU), ``_sinusoids``, ``encode``, the
smoke model's forward (plain and flash paths), loss, and step-by-step decode
against JAX's decode.  The reference's decode rotates every token of a call
by the call's cache index (``whisper.py:167``) where its forward rotates
none, so a one-call fill at index 0 equals forward and step-by-step decode
does not: a test pins that gap in both packages."""

import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    BatchScheduler, Request, make_serve_step, serve_waves,
)

ARCH = "whisper-large-v3"
# the dense family's tolerance (tests/test_torch_transformer.py)
F32 = dict(atol=1e-4, rtol=1e-4)
S_ENC = 12


def _np(t):
    return t.detach().float().numpy()


def test_layernorm_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 64) * 3 + 1).astype(np.float32)
    p = {"scale": rng.randn(64).astype(np.float32), "bias": rng.randn(64).astype(np.float32)}
    want = JC.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = C.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_gelu_mlp_matches_jax_tanh_gelu():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 64).astype(np.float32)
    p = {"wi": {"w": rng.randn(64, 128).astype(np.float32) * 0.3},
         "wo": {"w": rng.randn(128, 64).astype(np.float32) * 0.1}}
    jdt, tdt = JC.DTypes(), C.DTypes()
    want = JC.gelu_mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jdt)
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    got = C.gelu_mlp(tp, torch.from_numpy(x), tdt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the erf form is another function: it misses by far more than the tolerance
    h = torch.nn.functional.gelu(C.linear(tp["wi"], torch.from_numpy(x), tdt))
    assert np.abs(C.linear(tp["wo"], h, tdt).numpy() - np.asarray(want)).max() > 1e-4


# the two libms' f32 exp differ by one ulp in some timescales (6e-8), which
# the angle t * inv carries to t * 6e-8 rad, plus half an ulp of the product
# (6e-5 at t ~ 1500): 1.3e-4 at whisper-large-v3's 1500 frames
@pytest.mark.parametrize("length, d, atol", [(12, 64, 1e-6), (1500, 1280, 2.5e-4)])
def test_sinusoids_match_jax(length, d, atol):
    np.testing.assert_allclose(whisper._sinusoids(length, d).numpy(),
                               np.asarray(jwhisper._sinusoids(length, d)), atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax():
    cfg = jax_smoke(ARCH)
    zoo = jax_get_model(cfg)
    params = zoo.init(jax.random.PRNGKey(0))
    return (zoo, jax.jit(zoo.forward), jax.jit(zoo.decode_step), jax.jit(zoo.loss),
            jax.jit(lambda p, e: jwhisper.encode(p, cfg, e)), params)


def _port(attn_impl="ref"):
    zoo = get_model(dataclasses.replace(get_smoke_config(ARCH), attn_impl=attn_impl))
    np_tree = jax.tree_util.tree_map(np.asarray, _jax()[-1])
    return zoo, ParamTree.from_state_dict(params_from_jax(np_tree, dtype="float32", device="cpu"))


def _inputs(B=2, S=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S_ENC, 64).astype(np.float32),
            rng.randint(0, 128, (B, S)).astype(np.int32))


def test_param_tree_matches_jax():
    jshapes = {".".join(str(k.key) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(_jax()[-1])[0]}
    zoo, _ = _port()
    tshapes = {k: tuple(v.shape) for k, v in zoo.init(0, device="cpu").state_dict().items()}
    assert tshapes == jshapes
    assert tshapes["dec_pos"] == (32768, 64) and "dec_layers.cross_attn.wq.w" in tshapes


def test_encode_matches_jax():
    *_, jenc, jp = _jax()
    zoo, tp = _port("flash")
    emb, _ = _inputs()
    want = jenc(jp, jnp.asarray(emb))
    got = zoo.encode(tp, torch.from_numpy(emb))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_forward_matches_jax(attn_impl):
    _, jfwd, *_, jp = _jax()
    zoo, tp = _port(attn_impl)
    emb, toks = _inputs(seed=1)
    want, _ = jfwd(jp, {"enc_embeds": jnp.asarray(emb), "tokens": jnp.asarray(toks)})
    got, aux = zoo.forward(tp, {"enc_embeds": torch.from_numpy(emb),
                                "tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 8, 128) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_loss_matches_jax():
    _, _, _, jloss, _, jp = _jax()
    zoo, tp = _port("flash")
    emb, toks = _inputs(seed=2)
    tgt = _inputs(seed=3)[1]
    jl, jm = jloss(jp, {"enc_embeds": jnp.asarray(emb), "tokens": jnp.asarray(toks),
                        "targets": jnp.asarray(tgt)})
    tl, tm = zoo.loss(tp, {"enc_embeds": torch.from_numpy(emb),
                           "tokens": torch.from_numpy(toks).long(),
                           "targets": torch.from_numpy(tgt).long()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm["nll"].item(), float(jm["nll"]), rtol=1e-5)


def _decode_both(emb, toks, calls):
    """JAX's and the port's decode over ``calls`` ((lo, hi) token spans),
    the cache's enc_out set to each package's encode: [(jax, port) logits]."""
    jzoo, _, jdec, _, jenc, jp = _jax()
    zoo, tp = _port()
    jc = jwhisper.init_cache(jzoo.cfg, 2, 12, enc_len=S_ENC)
    jc["enc_out"] = jenc(jp, jnp.asarray(emb))
    tc = zoo.init_cache(2, 12, device="cpu")
    tc["enc_out"] = zoo.encode(tp, torch.from_numpy(emb))
    out = []
    for lo, hi in calls:
        want, jc = jdec(jp, jc, {"tokens": jnp.asarray(toks[:, lo:hi])})
        got, tc = zoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()})
        out.append((np.asarray(want), _np(got)))
    assert tc["index"] == int(jc["index"]) == calls[-1][1]
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **F32)
    np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), **F32)
    return out


def test_step_by_step_decode_matches_jax_decode():
    emb, toks = _inputs(seed=4)
    for want, got in _decode_both(emb, toks, [(0, 3)] + [(t, t + 1) for t in range(3, 8)]):
        np.testing.assert_allclose(got, want, **F32)


def test_one_call_fill_equals_forward():
    zoo, tp = _port("flash")
    emb, toks = _inputs(seed=5)
    batch = {"enc_embeds": torch.from_numpy(emb), "tokens": torch.from_numpy(toks).long()}
    logits, _ = zoo.forward(tp, batch)
    cache = zoo.init_cache(2, 8, device="cpu")
    cache["enc_out"] = zoo.encode(tp, batch["enc_embeds"])
    fill, cache = zoo.decode_step(tp, cache, {"tokens": batch["tokens"]})
    np.testing.assert_allclose(_np(fill), _np(logits), **F32)
    assert cache["index"] == 8


def test_step_by_step_decode_departs_from_forward_as_the_reference_does():
    """B 2, S 8, 12 encoder frames: each package's token-by-token decode
    against its own forward misses by O(1) (the reference's rope at the
    cache index), and the two packages miss alike."""
    _, jfwd, *_, jp = _jax()
    zoo, tp = _port()
    emb, toks = _inputs(seed=6)
    jf, _ = jfwd(jp, {"enc_embeds": jnp.asarray(emb), "tokens": jnp.asarray(toks)})
    tf, _ = zoo.forward(tp, {"enc_embeds": torch.from_numpy(emb),
                             "tokens": torch.from_numpy(toks).long()})
    steps = _decode_both(emb, toks, [(t, t + 1) for t in range(8)])
    jstep = np.concatenate([w for w, _ in steps], axis=1)
    tstep = np.concatenate([g for _, g in steps], axis=1)
    jgap, tgap = np.abs(jstep - np.asarray(jf)), np.abs(tstep - _np(tf))
    assert jgap[:, 0].max() < 1e-4                  # index 0 rotates nothing
    assert jgap.max() > 0.1 * np.asarray(jf).std()  # later steps do
    np.testing.assert_allclose(tgap, jgap, atol=2e-4)


def test_serve_waves_fills_enc_out_and_answers():
    """enc_embeds per request: the prefill (forward on tokens and frames,
    flash path) equals the one-call fill at index 0, whose cache holds
    encode's output."""
    zoo, tp = _port("flash")
    arts = make_serve_step(zoo, device="cpu")
    assert arts.encode_fn is not None
    sched = BatchScheduler(slots=2, eos_id=-1)
    rng = np.random.RandomState(7)
    reqs = [Request(rid=i, prompt=rng.randint(0, 128, 6), max_new=3,
                    enc_embeds=rng.randn(S_ENC, 64).astype(np.float32)) for i in range(2)]
    for r in reqs:
        sched.submit(r)
    waves = serve_waves(zoo, arts, tp, sched, 8, device="cpu")
    assert all(r.done and len(r.generated) == 3 for r in reqs)
    np.testing.assert_allclose(_np(waves[0].prefill_last), _np(waves[0].fill_last), **F32)


def _mesh(shape):
    return types.SimpleNamespace(shape=shape, mesh_dim_names=("pod", "data", "model"))


def test_sharding_and_param_count_are_the_references():
    """The sharded form (tests/test_torch_fsdp_families.py): the vocab of
    51866 splits over a "model" axis of 2 and stays whole over 4, as the
    reference's sanitize_specs keeps it; the 20 heads split over both."""
    zoo = get_model(get_smoke_config(ARCH))
    assert zoo.shard_plan(S.param_layout(zoo, _mesh((2, 2, 2)))).heads
    full_zoo = get_model(get_config(ARCH))
    for model, vocab in ((2, True), (4, False)):
        plan = full_zoo.shard_plan(S.param_layout(full_zoo, _mesh((1, 2, model))))
        assert (plan.heads, plan.mlp, plan.embed_vocab, plan.head_vocab) == (
            True, True, vocab, vocab)
    # the reference's count (SwiGLU MLPs, no dec_pos) is kept; the leaves differ
    full = get_config(ARCH)
    assert full.param_count() == jax_config(ARCH).param_count()
    leaves = sum(int(np.prod(s)) for s in get_model(full).param_shapes().values())
    assert full.param_count() == 1_744_110_080 and leaves == 1_576_752_640
