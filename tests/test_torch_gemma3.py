"""gemma3-4b's family in the port against the JAX package: gemma3-smoke's
param tree, forward (plain and flash paths), loss and decode with prompts
longer than its window of 8, so that the local layers mask keys the global
ones see; the flash path's plain version at head_dim 320 (gemma3-4b's
2560 / 8) against JAX's Pallas kernel in interpret mode; and the registry,
which now holds every architecture of the reference's."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ALL_CONFIGS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402

ARCH = "gemma3-4b"
# the dense family's tolerance (tests/test_torch_transformer.py): f32 on both
# sides, XLA and torch differ in sum order and libm only
F32 = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax(attn_impl="ref"):
    zoo = jax_get_model(dataclasses.replace(jax_smoke(ARCH), attn_impl=attn_impl))
    return zoo, jax.jit(zoo.forward), jax.jit(zoo.decode_step), jax.jit(zoo.loss)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return _jax()[0].init(jax.random.PRNGKey(0))


def _port(attn_impl="ref"):
    zoo = get_model(dataclasses.replace(get_smoke_config(ARCH), attn_impl=attn_impl))
    np_tree = jax.tree_util.tree_map(np.asarray, _jax_params())
    return zoo, ParamTree.from_state_dict(params_from_jax(np_tree, dtype="float32", device="cpu"))


def _tokens(B=2, S=20, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def test_smoke_config_binds_its_window():
    cfg = get_smoke_config(ARCH)
    assert (cfg.sliding_window, cfg.global_every, cfg.qk_norm) == (8, 3, True)
    assert transformer._is_global_flags(cfg) == [False, False, True, False, False, True]
    full = get_config(ARCH)
    assert full.resolved_head_dim == 320
    assert transformer._is_global_flags(full).count(True) == 5  # layers 5, 11, 17, 23, 29


def test_param_tree_matches_jax():
    jshapes = {".".join(str(k.key) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(_jax_params())[0]}
    zoo, _ = _port()
    tshapes = {k: tuple(v.shape) for k, v in zoo.init(0, device="cpu").state_dict().items()}
    assert tshapes == jshapes
    assert "layers.attn.q_norm.scale" in tshapes and "lm_head.w" not in tshapes


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_forward_matches_jax(attn_impl):
    """S 20 > window 8; the port's flash path takes each layer's window."""
    _, jfwd, _, _ = _jax()
    zoo, tp = _port(attn_impl)
    toks = _tokens()
    want, _ = jfwd(_jax_params(), {"tokens": jnp.asarray(toks)})
    got, aux = zoo.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 20, 128) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_window_changes_the_local_layers():
    """The windows bind at S 20: without them the logits differ."""
    zoo, tp = _port()
    toks = torch.from_numpy(_tokens()).long()
    got, _ = zoo.forward(tp, {"tokens": toks})
    wide = get_model(dataclasses.replace(zoo.cfg, sliding_window=None, global_every=None))
    other, _ = wide.forward(tp, {"tokens": toks})
    assert (got - other)[:, 8:].abs().max() > 1e-3
    np.testing.assert_allclose(_np(got[:, :8]), _np(other[:, :8]), **F32)


def test_loss_matches_jax():
    _, _, _, jloss = _jax()
    zoo, tp = _port("flash")
    toks, tgt = _tokens(seed=1), _tokens(seed=2)
    jl, jm = jloss(_jax_params(), {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})
    tl, tm = zoo.loss(tp, {"tokens": torch.from_numpy(toks).long(),
                           "targets": torch.from_numpy(tgt).long()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm["nll"].item(), float(jm["nll"]), rtol=1e-5)


def test_decode_matches_jax():
    """A fill of 12 tokens, then one-token steps to position 16: logits and
    cache; every step past 8 has keys outside a local layer's window."""
    jzoo, _, jdec, _ = _jax()
    zoo, tp = _port()
    toks = _tokens(S=16, seed=3)
    jp = _jax_params()
    jc, tc = jzoo.init_cache(2, 20), zoo.init_cache(2, 20, device="cpu")
    for lo, hi in [(0, 12), (12, 13), (13, 14), (14, 15), (15, 16)]:
        want, jc = jdec(jp, jc, {"tokens": jnp.asarray(toks[:, lo:hi])})
        got, tc = zoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert tc["index"] == int(jc["index"]) == 16
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **F32)


def test_decode_matches_forward():
    """Teacher-forced steps against the flash forward (the reference's own
    smoke tolerance), across the window."""
    zoo, tp = _port("flash")
    toks = torch.from_numpy(_tokens(B=1, S=14, seed=4)).long()
    logits, _ = zoo.forward(tp, {"tokens": toks})
    cache, outs = zoo.init_cache(1, 14, device="cpu"), []
    for t in range(14):
        lg, cache = zoo.decode_step(tp, cache, {"tokens": toks[:, t:t + 1]})
        outs.append(lg)
    assert torch.allclose(torch.cat(outs, dim=1), logits, atol=2e-2)


# head_dim 320 through the flash path's plain version and JAX's Pallas kernel
# (interpret mode, its (128, 320) blocks), windowed and not
D320_CASES = [
    # B, H, Hk, S, window, dtype
    (1, 2, 1, 256, None, "float32"),
    (1, 2, 1, 256, 64, "float32"),
    (1, 4, 2, 128, 32, "bfloat16"),
]
# tests/test_torch_flash_attention.py's tolerances: f32 2e-5, bf16 2e-2
D320_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("case", D320_CASES)
def test_flash_plain_path_at_head_dim_320_matches_jax_pallas(case):
    B, H, Hk, S, window, dtype = case
    rng = np.random.RandomState(5)
    arrs = [rng.randn(B, S, H, 320), rng.randn(B, S, Hk, 320), rng.randn(B, S, Hk, 320)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype)) for a in jx]
    want = jax_flash(*jx, causal=True, window=window)
    got = flash_attention(*tx, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=D320_TOL[dtype])


def test_head_dim_ranges():
    """The forward and the backward take 320; both refuse 48 (on the card,
    before any launch)."""
    fa.check_head_dim(320)
    fa.check_head_dim(320, fa.BWD_HEAD_DIMS)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.check_head_dim(48)
    with pytest.raises(ValueError, match=r"head_dim 48 .*backward"):
        fa.check_head_dim(48, fa.BWD_HEAD_DIMS)


@pytest.mark.parametrize("arch", ALL_CONFIGS)
def test_every_reference_architecture_is_served_by_the_registry(arch):
    """get_config / get_smoke_config / get_model for all of the reference's
    names; the smoke model's leaves have the reference's shapes."""
    assert get_config(arch).name == jax_config(arch).name
    cfg = get_smoke_config(arch)
    assert cfg.name == jax_smoke(arch).name
    zoo = get_model(cfg)
    jshapes = jax.eval_shape(jax_get_model(jax_smoke(arch)).init, jax.random.PRNGKey(0))
    want = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert zoo.param_shapes() == want
