"""Port building blocks (repro_torch.models.common, interop, configs, device)
against the JAX package on the same numpy inputs, plus the rule that the
port imports neither JAX nor the JAX package."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch import device as tdevice  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.interop import params_from_jax, torch_dtype  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
# f32 on both sides; only the order of sums and the libm differ
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _tree(rng, shapes):
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def test_rmsnorm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3
    scale = rng.randn(64).astype(np.float32)
    want = JC.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = TC.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_jax(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = rng.randint(0, 300, (2, 7)).astype(np.int32)
    want = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # f32 angles up to ~300 rad: one ulp of the angle is ~3e-5
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_rope_is_half_split_not_interleaved():
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0  # pairs with dim 4 in the half-split form
    out = TC.apply_rope(x, torch.tensor([[1]]), 10000.0)
    assert out[..., 4].abs().item() > 0.5 and out[..., 1].abs().item() == 0.0


def test_swiglu_and_linear_match_jax():
    rng = np.random.RandomState(2)
    p = {k: {"w": w} for k, w in _tree(rng, {"wi": (32, 48), "wg": (32, 48), "wo": (48, 32)}).items()}
    x = rng.randn(2, 3, 32).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    dtj, dtt = JC.DTypes(), TC.DTypes()
    np.testing.assert_allclose(
        _np(TC.swiglu(tp, torch.from_numpy(x), dtt)), np.asarray(JC.swiglu(jp, jnp.asarray(x), dtj)), **TOL)
    np.testing.assert_allclose(
        _np(TC.linear(tp["wi"], torch.from_numpy(x), dtt)),
        np.asarray(JC.linear(jp["wi"], jnp.asarray(x), dtj)), **TOL)


def test_embed_unembed_match_jax():
    rng = np.random.RandomState(3)
    table = rng.randn(50, 16).astype(np.float32)
    ids = rng.randint(0, 50, (2, 9)).astype(np.int32)
    x = rng.randn(2, 9, 16).astype(np.float32)
    dtj, dtt = JC.DTypes(), TC.DTypes()
    np.testing.assert_array_equal(
        _np(TC.embed({"table": torch.from_numpy(table)}, torch.from_numpy(ids).long(), dtt)),
        np.asarray(JC.embed({"table": jnp.asarray(table)}, jnp.asarray(ids), dtj)))
    np.testing.assert_allclose(
        _np(TC.unembed({"table": torch.from_numpy(table)}, torch.from_numpy(x), dtt)),
        np.asarray(JC.unembed({"table": jnp.asarray(table)}, jnp.asarray(x), dtj)), **TOL)


def test_bf16_dtype_policy_matches_jax():
    rng = np.random.RandomState(4)
    w = rng.randn(32, 24).astype(np.float32)
    x = rng.randn(3, 32).astype(np.float32)
    dtj = JC.DTypes(jnp.bfloat16, jnp.bfloat16)
    dtt = TC.DTypes(torch.bfloat16, torch.bfloat16)
    want = JC.linear({"w": jnp.asarray(w, jnp.bfloat16)}, jnp.asarray(x, jnp.bfloat16), dtj)
    got = TC.linear({"w": torch.from_numpy(w).bfloat16()}, torch.from_numpy(x).bfloat16(), dtt)
    assert got.dtype == torch.bfloat16
    # both round the f32-accumulated product once to bf16: within one bf16 ulp
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (False, 3, 4)])
def test_sdpa_matches_jax(causal, window, q_offset):
    rng = np.random.RandomState(6)
    q = rng.randn(2, 5, 4, 8).astype(np.float32)
    k, v = (rng.randn(2, 9, 2, 8).astype(np.float32) for _ in range(2))
    want = JC.sdpa(*map(jnp.asarray, (q, k, v)), causal, window, 0.3, q_offset)
    got = TC.sdpa(*map(torch.from_numpy, (q, k, v)), causal, window, 0.3, q_offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_attention_with_cache_matches_jax():
    """Prefill, then cache writes: a fill, a step, and a write past the end
    that clamps its start while the mask keeps the index."""
    rng = np.random.RandomState(7)
    jcfg = JC.AttnConfig(d_model=16, heads=4, kv_heads=2, head_dim=4, rope_theta=500.0)
    tcfg = TC.AttnConfig(d_model=16, heads=4, kv_heads=2, head_dim=4, rope_theta=500.0)
    p = {k: {"w": w} for k, w in _tree(rng, {"wq": (16, 16), "wk": (16, 8), "wv": (16, 8),
                                             "wo": (16, 16)}).items()}
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(torch.from_numpy, p)
    x = rng.randn(2, 7, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    jattn = jax.jit(JC.attention, static_argnums=(1, 4))
    want, _ = jattn(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), JC.DTypes())
    got, kv = TC.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos).long(), TC.DTypes())
    assert kv is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    jkv = (jnp.zeros((2, 6, 2, 4)),) * 2
    tkv = (torch.zeros(2, 6, 2, 4), torch.zeros(2, 6, 2, 4))
    index = 0
    for lo, hi in [(0, 4), (4, 5), (5, 7)]:  # the last write starts at 5 and clamps to 4
        xs, ps = x[:, lo:hi], pos[:, lo:hi]
        want, jkv = jattn(jp, jcfg, jnp.asarray(xs), jnp.asarray(ps), JC.DTypes(),
                          kv_cache=jkv, cache_index=jnp.asarray(index))
        got, tkv = TC.attention(tp, tcfg, torch.from_numpy(xs), torch.from_numpy(ps).long(),
                                TC.DTypes(), kv_cache=tkv, cache_index=index)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(_np(tkv[0]), np.asarray(jkv[0]), **TOL)
        index += hi - lo


def test_trunc_normal_is_cut_at_two_sigma_then_scaled():
    g = torch.Generator().manual_seed(0)
    x = TC.trunc_normal(g, (20000,), 0.5, torch.float32, "cpu")
    assert x.abs().max().item() <= 1.0 + 1e-6
    # std of a unit normal cut at ±2 is 0.8796
    assert abs(x.std().item() - 0.5 * 0.8796) < 0.01
    assert TC.trunc_normal(g, (4,), 1.0, torch.bfloat16, "cpu").dtype == torch.bfloat16


def test_stack_params_and_param_tree():
    g = torch.Generator().manual_seed(0)
    stacked = TC.stack_params(g, 3, lambda g: {"a": {"w": torch.randn(2, 4, generator=g)},
                                               "n": torch.ones(4)})
    assert stacked["a"]["w"].shape == (3, 2, 4) and stacked["n"].shape == (3, 4)
    tree = TC.ParamTree(stacked)
    assert set(tree.state_dict()) == {"a.w", "n"}
    assert "a" in tree and "n" in tree and "b" not in tree
    back = TC.ParamTree.from_state_dict(tree.state_dict())
    assert torch.equal(back["a"]["w"], stacked["a"]["w"])
    layer = TC.layer_slice(tree, 1)
    assert torch.equal(layer["a"]["w"], stacked["a"]["w"][1])
    assert not tree["a"]["w"].requires_grad


def test_layer_slices_unbind_each_leaf_once():
    g = torch.Generator().manual_seed(1)
    tree = TC.ParamTree({"a": {"w": torch.randn(3, 2, 4, generator=g)}, "n": torch.ones(3, 4)},
                        requires_grad=True)
    layers = TC.layer_slices(tree, 3)
    for i, layer in enumerate(layers):
        assert torch.equal(layer["a"]["w"], TC.layer_slice(tree, i)["a"]["w"])
        assert torch.equal(layer["n"], tree["n"][i])
    # one backward node per leaf, shared by its layers
    assert layers[0]["a"]["w"].grad_fn is layers[2]["a"]["w"].grad_fn
    sum(l["a"]["w"].sum() * (i + 1) for i, l in enumerate(layers)).backward()
    want = torch.arange(1.0, 4.0)[:, None, None].expand(3, 2, 4)
    assert torch.equal(tree["a"]["w"].grad, want)


def test_params_from_jax_flattens_and_crosses_bf16():
    rng = np.random.RandomState(5)
    jtree = {
        "embed": {"table": jnp.asarray(rng.randn(4, 3), jnp.bfloat16)},
        "layers": {"attn": {"wq": {"w": jnp.asarray(rng.randn(2, 3, 3), jnp.float32)}}},
    }
    np_tree = jax.tree_util.tree_map(np.asarray, jtree)  # read-only arrays
    sd = params_from_jax(np_tree, dtype=jnp.bfloat16, device="cpu")
    assert set(sd) == {"embed.table", "layers.attn.wq.w"}
    assert sd["embed.table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(sd["embed.table"]), np.asarray(jtree["embed"]["table"], np.float32))
    sd["layers.attn.wq.w"].add_(1)  # owns its buffer
    cache = params_from_jax(
        {"k": np.zeros((1, 2, 4, 1, 8), np.float32), "index": np.asarray(3, np.int32)},
        dtype="float32", device="cpu")
    assert cache["index"] == 3 and isinstance(cache["index"], int)


def test_torch_dtype_map():
    assert torch_dtype(jnp.float32) is torch.float32
    assert torch_dtype(jnp.bfloat16) is torch.bfloat16
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype(torch.float16) is torch.float16
    with pytest.raises(KeyError):
        torch_dtype(np.complex64)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-8b", "granite-20b", "zamba2-7b",
                                  "xlstm-125m", "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
                                  "paper-llama3-moe", "gemma3-4b", "qwen2-vl-2b",
                                  "whisper-large-v3"])
def test_configs_match_reference(arch):
    mine, ref = get_config(arch), jax_get_config(arch)
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert a is torch_dtype(b), f.name
        elif f.name == "moe" and b is not None:  # the port's own MoEParams
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert mine.param_count() == ref.param_count()


def test_registry_names_later_slices():
    """Every architecture of the reference's registry is ported."""
    from repro.configs.registry import ALL_CONFIGS

    assert sorted(ARCHS) == sorted(ALL_CONFIGS)
    with pytest.raises(KeyError, match="unknown"):
        get_config("nope")


def test_device_resolve_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve(None)
    assert tdevice.resolve("cpu") == torch.device("cpu")


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."))
n = sum(1 for n in sys.modules if n.startswith("repro_torch"))
print(n, bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert int(out.stdout.split()[0]) >= 15  # every module was imported


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names, "no imports found"
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), name


def test_kernel_bounds_of_the_kernels_still_to_port():
    from repro_torch.kernels import bounds

    ssd, mlstm = bounds.ssd_bound(), bounds.mlstm_bound()
    # zamba2-7b, 16 chunks x 4 batch: C B^T (2 * 64^3) once, shared by the
    # 112 heads, and 3 products of 2 * 64^3 per head
    assert ssd["flops"] == (1 + 3 * 112) * 2 * 64 ** 3 * 16 * 4
    # xlstm-125m, 4 heads x 16 chunks x 4 batch: 2 products of 2 * 64^2 * 192
    # and 2 of 2 * 64 * 192^2; q.n_t reuses w o q k^T, so no w k product
    assert mlstm["flops"] == (2 * 2 * 64 ** 2 * 192 + 2 * 2 * 64 * 192 ** 2) * 4 * 16 * 4
    # the path is f32: f32 bytes; the f32-accurate rate is 3xTF32 on the
    # tensor cores, 495 / 3 = 165 TFLOP/s, above the f32 SIMT peak of 67
    assert bounds.PEAK_FLOPS == 165e12 and bounds.PEAK_SIMT == 67e12 and bounds.F32 == 4
    assert ssd["bound_by"] == "bytes" and mlstm["bound_by"] == "operations"
    assert ssd["bound_ms"] == ssd["bytes"] / bounds.PEAK_BYTES * 1e3
    assert mlstm["bound_ms"] == mlstm["flops"] / bounds.PEAK_FLOPS * 1e3
    assert abs(ssd["bound_ms"] - 0.0713) < 1e-4 and abs(ssd["bytes"] - 238.8e6) < 0.1e6
    assert abs(mlstm["bound_ms"] - 0.0195) < 1e-4 and abs(mlstm["bytes"] - 50.46e6) < 0.01e6
    # the f32 SIMT bounds the first ports were held to, kept beside them
    assert ssd["simt_bound_by"] == mlstm["simt_bound_by"] == "operations"
    assert ssd["simt_bound_ms"] == ssd["flops"] / bounds.PEAK_SIMT * 1e3
    assert abs(ssd["simt_bound_ms"] - 0.1688) < 1e-4
    assert abs(mlstm["simt_bound_ms"] - 0.0481) < 1e-4
