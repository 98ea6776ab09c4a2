"""The port's dense transformer (forward, decode, cache, loss) against the
JAX package for the three dense smoke configs, with the JAX weights carried
over by params_from_jax."""

import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.parallel.sharding import make_rules, use_rules  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax, torch_dtype  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

ARCHS = ["llama3.2-3b", "qwen3-8b", "granite-20b"]
# f32 on both sides: XLA and torch differ only in sum order and libm (rope
# angles), ~1e-6 on logits of unit scale; 1e-4 leaves room for 2 layers
F32 = dict(atol=1e-4, rtol=1e-4)


class _Jitted:
    """The JAX zoo with init / forward / decode_step / loss jitted: compiled once
    per shape instead of retraced on every call."""

    def __init__(self, zoo):
        self.cfg = zoo.cfg
        self.init = jax.jit(zoo.init)
        self.init_cache = zoo.init_cache
        self.forward = jax.jit(zoo.forward)
        self.decode_step = jax.jit(zoo.decode_step)
        self.loss = jax.jit(zoo.loss)


@functools.lru_cache(maxsize=None)
def _jax_zoo(cfg):
    return _Jitted(jax_get_model(cfg))


def _pair(arch, **overrides):
    jcfg = dataclasses.replace(jax_smoke(arch), **overrides)
    toverrides = {k: (torch_dtype(v) if k.endswith("dtype") else v) for k, v in overrides.items()}
    tcfg = dataclasses.replace(get_smoke_config(arch), **toverrides)
    return _jax_zoo(jcfg), get_model(tcfg)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32"):
    jzoo, _ = _pair(arch, param_dtype=getattr(jnp, dtype), compute_dtype=getattr(jnp, dtype))
    return jzoo.init(jax.random.PRNGKey(0))


def _port_params(arch, dtype="float32"):
    np_tree = jax.tree_util.tree_map(np.asarray, _jax_params(arch, dtype))
    return ParamTree.from_state_dict(params_from_jax(np_tree, dtype=dtype, device="cpu"))


def _tokens(vocab, B=2, S=16, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    jzoo, tzoo = _pair(arch)
    jshapes = {".".join(str(k.key) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(_jax_params(arch))[0]}
    tshapes = {k: tuple(v.shape) for k, v in tzoo.init(0, device="cpu").state_dict().items()}
    assert tshapes == jshapes


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jzoo, tzoo = _pair(arch)
    toks = _tokens(jzoo.cfg.vocab)
    want, _ = jzoo.forward(_jax_params(arch), {"tokens": jnp.asarray(toks)})
    got, aux = tzoo.forward(_port_params(arch), {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 16, jzoo.cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_forward_matches_jax_flash_under_one_device_mesh(arch):
    jzoo, tzoo = _pair(arch, attn_impl="flash")
    toks = _tokens(jzoo.cfg.vocab, S=32, seed=1)
    mesh = make_mesh((1,), ("data",))
    with use_rules(make_rules(("data",)), mesh):
        want, _ = jzoo.forward(_jax_params(arch), {"tokens": jnp.asarray(toks)})
    got, _ = tzoo.forward(_port_params(arch), {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    """A multi-token fill, then one-token steps: logits and cache."""
    jzoo, tzoo = _pair(arch)
    toks = _tokens(jzoo.cfg.vocab, S=9, seed=2)
    jp, tp = _jax_params(arch), _port_params(arch)
    jc, tc = jzoo.init_cache(2, 12), tzoo.init_cache(2, 12, device="cpu")
    for lo, hi in [(0, 6), (6, 7), (7, 8), (8, 9)]:
        want, jc = jzoo.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, lo:hi])})
        got, tc = tzoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert tc["index"] == int(jc["index"]) == 9
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **F32)
    np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), **F32)


def test_local_global_window_matches_jax():
    """Per-layer sliding window (gemma-style local:global) with
    attn_impl="flash", which passes each layer's window to the flash path
    (its plain version on the CPU): forward and decode."""
    arch = "llama3.2-3b"
    jzoo, tzoo = _pair(arch, sliding_window=4, global_every=2, attn_impl="flash")
    toks = _tokens(jzoo.cfg.vocab, S=12, seed=8)
    jp, tp = _jax_params(arch), _port_params(arch)
    want, _ = jzoo.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tzoo.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    jc, tc = jzoo.init_cache(2, 12), tzoo.init_cache(2, 12, device="cpu")
    for lo, hi in [(0, 7), (7, 8)]:
        want, jc = jzoo.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, lo:hi])})
        got, tc = tzoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode step by step matches the parallel forward
    (tests/test_models_smoke.py's tolerance)."""
    _, tzoo = _pair(arch, attn_impl="flash")
    tp = _port_params(arch)
    toks = torch.from_numpy(_tokens(tzoo.cfg.vocab, B=1, S=8, seed=3)).long()
    logits, _ = tzoo.forward(tp, {"tokens": toks})
    cache = tzoo.init_cache(1, 8, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = tzoo.decode_step(tp, cache, {"tokens": toks[:, t:t + 1]})
        outs.append(lg)
    assert torch.allclose(torch.cat(outs, dim=1), logits, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    jzoo, tzoo = _pair(arch)
    jp, tp = _jax_params(arch), _port_params(arch)
    prompt = _tokens(jzoo.cfg.vocab, S=5, seed=4)
    jc, tc = jzoo.init_cache(2, 12), tzoo.init_cache(2, 12, device="cpu")
    jt, tt = jnp.asarray(prompt), torch.from_numpy(prompt).long()
    jout, tout = [], []
    for _ in range(6):
        jl, jc = jzoo.decode_step(jp, jc, {"tokens": jt})
        tl, tc = tzoo.decode_step(tp, tc, {"tokens": tt})
        jt = jnp.argmax(jl[:, -1:], axis=-1)
        tt = tl[:, -1:].argmax(-1)
        jout.append(np.asarray(jt))
        tout.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(tout, 1), np.concatenate(jout, 1))


def test_bf16_forward_matches_jax():
    arch = "llama3.2-3b"
    jzoo, tzoo = _pair(arch, param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    toks = _tokens(jzoo.cfg.vocab, seed=5)
    want, _ = jzoo.forward(_jax_params(arch, "bfloat16"), {"tokens": jnp.asarray(toks)})
    got, _ = tzoo.forward(_port_params(arch, "bfloat16"), {"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    # both round to bf16 at the same ops, but where the f32 sums inside a
    # product differ in the last bit a rounding flips: two bf16 ulps at the
    # logits' magnitude (< 8, ulp 2^-5)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=2 * 2 ** -5, rtol=0)


def test_embedding_scale_is_rounded_to_compute_dtype():
    _, tzoo = _pair("llama3.2-3b", param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(tzoo.cfg, d_model=3072)
    from repro_torch.models import transformer

    table = {"table": torch.ones(4, 3072, dtype=torch.bfloat16)}
    x = transformer._embed({"embed": table}, cfg, {"tokens": torch.tensor([[1]])},
                           transformer._dt(cfg))
    assert x[0, 0, 0].item() == 55.5  # sqrt(3072) = 55.4256 rounds to 55.5


def test_cache_write_clamps_like_dynamic_update_slice():
    """index + S > cache_len: the write start is clamped, the mask is not."""
    arch = "llama3.2-3b"
    jzoo, tzoo = _pair(arch)
    jp, tp = _jax_params(arch), _port_params(arch)
    toks = _tokens(jzoo.cfg.vocab, S=10, seed=6)
    jc, tc = jzoo.init_cache(2, 8), tzoo.init_cache(2, 8, device="cpu")
    for lo, hi in [(0, 6), (6, 10)]:  # second write: start 6 clamps to 4
        want, jc = jzoo.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, lo:hi])})
        got, tc = tzoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert tc["index"] == int(jc["index"]) == 10
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **F32)


def test_loss_matches_jax():
    arch = "qwen3-8b"
    jzoo, tzoo = _pair(arch)
    toks = _tokens(jzoo.cfg.vocab, seed=7)
    tgt = np.roll(toks, -1, axis=1)
    mask = (np.arange(16) < 12).astype(np.float32)[None].repeat(2, 0)
    jl, jm = jzoo.loss(_jax_params(arch), {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
                                           "loss_mask": jnp.asarray(mask)})
    tl, tm = tzoo.loss(_port_params(arch), {"tokens": torch.from_numpy(toks).long(),
                                            "targets": torch.from_numpy(tgt),
                                            "loss_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm["nll"].item(), float(jm["nll"]), rtol=1e-5)


def test_unported_features_raise():
    _, tzoo = _pair("llama3.2-3b", attn_impl="pallas")
    with pytest.raises(ValueError, match="attn_impl"):
        tzoo.init(0, device="cpu")
    # M-RoPE is ported (tests/test_torch_vlm.py): a config with sections builds
    assert "embed.table" in _pair("llama3.2-3b", mrope_sections=(2, 3, 3))[1].init(
        0, device="cpu").state_dict()
    from repro_torch.configs import MoEParams

    _, moe = _pair("llama3.2-3b")
    # MoE layers are ported (tests/test_torch_moe.py): a config with ``moe``
    # builds its "moe" block in place of the "ffn" one
    moe_cfg = dataclasses.replace(moe.cfg, moe=MoEParams(num_experts=4, top_k=2, d_ff=32))
    keys = get_model(moe_cfg).init(0, device="cpu").state_dict()
    assert "layers.moe.wi" in keys and not any(".ffn." in k for k in keys)
    # whisper is ported (tests/test_torch_whisper.py), its sharding too
    # (tests/test_torch_fsdp_families.py): the heads and the MLP split on a
    # "model" axis of 2
    whisper = get_model(get_smoke_config("whisper-large-v3"))
    assert whisper.param_specs()["dec_layers"]["cross_attn"]["wq"]["w"] == ("stack", "fsdp",
                                                                            "heads")
    plan = whisper.shard_plan(S.param_layout(whisper, types.SimpleNamespace(
        shape=(2, 2, 2), mesh_dim_names=("pod", "data", "model"))))
    assert (plan.heads, plan.kv, plan.mlp) == (True, True, True)
