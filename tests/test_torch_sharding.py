"""The port's logical-axis sharding rules (``repro_torch.parallel.sharding``)
against the JAX package's: the rules, the logical spec trees of params and
caches, the non-dividing dims, the batch specs, and every leaf's block on
every mesh coordinate against ``NamedSharding.devices_indices_map`` of the
reference's own train and serve steps.  The blocks come from one JAX process
on 8 forced host devices; everything else runs in this process."""

import json
import os
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402

ARCHS = ("llama3.2-3b", "qwen3-8b", "granite-20b")
MESHES = {"pdm": ((2, 2, 2), ("pod", "data", "model")), "dm": ((4, 2), ("data", "model"))}
SLOTS, CACHE_LEN = 4, 16

JAX_SIDE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import get_model
from repro.serve.serve_step import make_serve_step
from repro.train.optimizer import AdamWConfig
from repro.train.train_step import make_train_step

archs, meshes, slots, cache_len = json.loads(sys.argv[2])
out = {}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        res = {}
        for k, v in tree.items():
            res.update(flat(v, f"{prefix}{k}."))
        return res
    return {prefix[:-1]: tree}

def blocks(mesh, sharding, shape):
    idx = sharding.devices_indices_map(tuple(shape))
    res = []
    for c in np.ndindex(*mesh.devices.shape):
        sl = idx[mesh.devices[c]]
        res.append([[s.start or 0, shape[d] if s.stop is None else s.stop]
                    for d, s in enumerate(sl)])
    return res

for arch in archs:
    zoo = get_model(get_smoke_config(arch))
    shapes = flat(jax.tree_util.tree_map(lambda a: list(a.shape),
                                         jax.eval_shape(lambda: zoo.init(jax.random.PRNGKey(0)))))
    cache_ex = jax.eval_shape(lambda: zoo.init_cache(slots, cache_len))
    cshapes = flat(jax.tree_util.tree_map(lambda a: list(a.shape), cache_ex))
    for name, (shape, axes) in meshes.items():
        mesh = make_mesh(tuple(shape), tuple(axes))
        ex = {"tokens": np.zeros((8, 16), np.int32), "targets": np.zeros((8, 16), np.int32)}
        arts = make_train_step(zoo, AdamWConfig(), mesh, ex)
        for k, s in flat(arts.param_sharding).items():
            out[f"{arch}|{name}|param|{k}"] = blocks(mesh, s, shapes[k])
        for k, s in flat(arts.opt_sharding.mu).items():
            out[f"{arch}|{name}|mu|{k}"] = blocks(mesh, s, shapes[k])
        sarts = make_serve_step(zoo, mesh, {"tokens": jnp.zeros((slots, 1), jnp.int32)},
                                cache_example=cache_ex)
        for k, s in flat(sarts.cache_sharding).items():
            if k != "index":
                out[f"{arch}|{name}|cache|{k}"] = blocks(mesh, s, cshapes[k])
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharding")
    arg = json.dumps([ARCHS, MESHES, SLOTS, CACHE_LEN])
    worlds.run_in_turn(tmp_path_factory, {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work / "blocks.json"), arg],
    }, worlds.jax_env(SRC, 8))
    with open(work / "blocks.json") as f:
        return json.load(f)


def _names_leaves(tree, prefix=""):
    if isinstance(tree, tuple):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_names_leaves(v, f"{prefix}{k}."))
    return out


def _norm(spec):
    """A PartitionSpec names a one-axis tuple by the axis alone."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _fake_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape))), dict(zip(axes, shape))


def test_default_rules_are_the_reference_rules():
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_specs_and_shapes_match_jax(arch):
    jzoo, zoo = jax_get_model(jax_smoke(arch)), get_model(get_smoke_config(arch))
    assert zoo.param_specs() == jzoo.param_specs()
    assert zoo.cache_specs() == jzoo.cache_specs()
    want = S.flatten(jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jax.eval_shape(lambda: jzoo.init(jax.random.PRNGKey(0)))))
    assert zoo.param_shapes() == want


@pytest.mark.parametrize("kind", [None, "train", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_specs_match_jax(arch, mesh, kind):
    """Every logical tuple of the param and cache specs maps to the
    reference's PartitionSpec, with and without a pod axis, and under
    ``attention_overrides`` for train and decode."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    axes = MESHES[mesh][1]
    ov = jov = None
    if kind is not None:
        tp = dict(zip(axes, MESHES[mesh][0]))["model"]
        ov, jov = S.attention_overrides(cfg, tp, kind), JS.attention_overrides(jcfg, tp, kind)
        assert ov == jov
    rules, jrules = S.make_rules(axes, ov), JS.make_rules(axes, jov)
    assert rules.table == jrules.table
    zoo = get_model(cfg)
    names = {**_names_leaves(zoo.param_specs()), **_names_leaves(zoo.cache_specs(), "cache.")}
    names["batch"] = ("batch", "seq", "embed")
    for key, logical in names.items():
        assert _norm(rules.spec(logical)) == _norm(jrules.spec(logical)), key


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8, 16, 48])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_overrides_match_jax(arch, tp):
    for kind in ("train", "decode"):
        assert S.attention_overrides(get_smoke_config(arch), tp, kind) == \
            JS.attention_overrides(jax_smoke(arch), tp, kind)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_jax(mesh):
    fake, sizes = _fake_mesh(mesh)
    for rows in (8, 4, 3, 1):
        ex = {"tokens": np.zeros((rows, 16)), "targets": np.zeros((rows, 16)),
              "positions3": np.zeros((3, rows, 16))}
        want = JT.batch_specs_tree(fake, ex)
        got = S.batch_specs_tree(sizes, ex)
        assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sanitized_specs_match_jax(arch, mesh):
    """Dims the mesh axes do not divide stay whole, as the reference's
    ``sanitize_specs`` leaves them (granite's one KV head: its Hk * Dh dim
    stays split over "model")."""
    fake, sizes = _fake_mesh(mesh)
    axes = MESHES[mesh][1]
    jzoo, zoo = jax_get_model(jax_smoke(arch)), get_model(get_smoke_config(arch))
    jspecs = JT.sanitize_specs(
        JS.logical_spec_tree(jzoo.param_specs(), JS.make_rules(axes)),
        jax.eval_shape(lambda: jzoo.init(jax.random.PRNGKey(0))), fake)
    want = {k: _norm(v) for k, v in S.flatten(jspecs).items()}
    got = S.sanitize_specs(S.flatten(S.logical_spec_tree(zoo.param_specs(), S.make_rules(axes))),
                           zoo.param_shapes(), sizes)
    assert {k: _norm(v) for k, v in got.items()} == want
    assert opt_lib.state_specs(got).mu == got
    assert S.flatten(jax_opt.state_specs(jspecs).mu) == S.flatten(jspecs)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_named_sharding(jax_blocks, arch, mesh):
    """Every param, AdamW moment and cache leaf: the block at each mesh
    coordinate and its shape, against the reference's train and serve
    steps' shardings."""
    shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    zoo = get_model(get_smoke_config(arch))
    fake = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    params = S.param_layout(zoo, fake)
    cache = S.cache_layout(zoo, fake, zoo.init_cache(SLOTS, CACHE_LEN, device="cpu"))
    trees = {"param": params, "mu": params, "cache": cache}
    checked = 0
    for tree, layout in trees.items():
        for key, spec in layout.specs.items():
            if key == "index":
                continue
            want = jax_blocks[f"{arch}|{mesh}|{tree}|{key}"]
            whole = layout.shapes[key]
            for i, c in enumerate(np.ndindex(*shape)):
                sl = S.block_slices(whole, spec, sizes, dict(zip(axes, c)))
                assert [[s.start, s.stop] for s in sl] == want[i], (tree, key, c)
                assert S.local_shape(whole, spec, sizes) == tuple(b - a for a, b in want[i])
                checked += 1
    assert checked == 8 * (2 * len(params.specs) + 2)
