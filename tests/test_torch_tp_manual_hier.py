"""The port's tensor parallelism inside ``manual_hier``, its rules
overrides, its MoE layers on other axes and its decode over a cache cut by
position, against the JAX package.

One gloo world of 8 ranks (``torch_dist_worlds.tp``) runs, from the JAX
inits at ``PRNGKey(0)``:

* ``manual_hier`` (hierarchical) with TP on "model" for every non-MoE
  family on (2, 2, 2) and (1, 2, 4), two steps each;
* ``gspmd_fsdp`` under the dry run's ``attention_overrides`` (KV heads
  whole on (1, 2, 4); heads whole and ``seq -> "model"`` on (1, 1, 8));
* moonshot-smoke's ``gspmd_fsdp`` with ``moe_ep_axis="model"`` on
  (2, 2, 2), and on (2, 4) ("pod", "model") and (8,) ("model",), meshes
  without "data", where the reference runs its MoE dense over the global
  batch;
* one-token decode at batch 1 over a cache cut by position,
  ``rules_overrides={"batch": None, "kv_seq": "data"}``, on (2,) and (4,)
  "data" meshes (a leading "rep" axis fills the world), llama and zamba2.

JAX runs the reference's ``make_train_step`` / ``make_serve_step`` with the
same meshes and overrides in its own process on 8 forced host devices.  Its
``manual_hier`` step runs each family on one of the two meshes (the dense
family on (1, 2, 4) here and on (2, 2, 2) in ``test_torch_dist_train.py``):
on both meshes the reference's step is its one-device function to float
rounding, and the port's step on both is held against it."""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.parallel.sharding import (  # noqa: E402
    attention_overrides as jax_attention_overrides, logical_spec_tree, make_rules,
)
from repro.train.train_step import sanitize_specs as jax_sanitize  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    attention_overrides, cache_layout, entry_axes, flatten, param_layout,
)
from repro_torch.train.train_step import step_layout  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402
from test_torch_family_train import S_ENC, _grid3  # noqa: E402
from test_torch_fsdp import F32, JAX_LOSS_ATOL, RANKS, _tree  # noqa: E402
from test_torch_train import _assert_params_close  # noqa: E402

B, S = 8, 16
# the mesh on which the reference's manual_hier step runs each family
JAX_TP_MESH = {"llama3.2-3b": (1, 2, 4), "gemma3-4b": (2, 2, 2), "qwen2-vl-2b": (1, 2, 4),
               "whisper-large-v3": (2, 2, 2), "zamba2-7b": (1, 2, 4), "xlstm-125m": (2, 2, 2)}

JAX_SIDE = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import get_model
from repro.parallel.sharding import attention_overrides
from repro.serve.serve_step import make_serve_step
from repro.train.optimizer import AdamWConfig, init as opt_init
from repro.train.train_step import make_train_step

workdir, steps, kv_cache = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
tp_cases = [c.split("@") for c in sys.argv[4].split(",")]
inp = np.load(workdir + "/inputs.npz")
ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
out = {}

def batch(arch, i):
    pre = f"tp/{arch}/{i}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        res = {}
        for k, v in tree.items():
            res.update(flat(v, f"{prefix}{k}."))
        return res
    return {prefix[:-1]: tree}

def run(tag, arch, cfg, mesh, **kw):
    zoo = get_model(cfg)
    arts = make_train_step(zoo, ocfg, mesh, batch(arch, 0), **kw)
    p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    o = jax.device_put(opt_init(ocfg, zoo.init(jax.random.PRNGKey(0))), arts.opt_sharding)
    hist = {"loss": [], "grad_norm": [], "aux": []}
    for i in range(steps):
        b = batch(arch, i)
        p, o, m = arts.step_fn(p, o, {k: jax.device_put(v, arts.batch_sharding[k])
                                      for k, v in b.items()})
        for k in hist:
            hist[k].append(float(m[k]))
    out.update({f"{tag}.{k}": v for k, v in hist.items()})
    for k, v in flat(p).items():
        out[f"{tag}.param.{k}"] = np.asarray(v)
    for k, v in flat(arts.param_sharding).items():
        out[f"{tag}.spec.{k}"] = repr(tuple(v.spec))

axes3 = ("pod", "data", "model")
for arch, shape in tp_cases:
    shape = tuple(int(c) for c in shape)
    run(f"tp.{arch}", arch, get_smoke_config(arch), make_mesh(shape, axes3),
        dp_mode="manual_hier", schedule="hierarchical")

for name, shape in (("kv_whole", (1, 2, 4)), ("heads_whole", (1, 1, 8))):
    cfg = get_smoke_config("llama3.2-3b")
    run(f"ov.{name}", "llama3.2-3b", cfg, make_mesh(shape, axes3),
        rules_overrides=attention_overrides(cfg, shape[-1], "train"))

moon = get_smoke_config("moonshot-v1-16b-a3b")
for name, shape, axes, fields in (("ep_model", (2, 2, 2), axes3, {"moe_ep_axis": "model"}),
                                  ("pod_model", (2, 4), ("pod", "model"), {}),
                                  ("model", (8,), ("model",), {})):
    run(f"moe.{name}", "moonshot-v1-16b-a3b", dataclasses.replace(moon, **fields),
        make_mesh(shape, axes))

for name, arch, n in (("llama_d2", "llama3.2-3b", 2), ("llama_d4", "llama3.2-3b", 4),
                      ("zamba2_d2", "zamba2-7b", 2), ("zamba2_d4", "zamba2-7b", 4)):
    zoo = get_model(get_smoke_config(arch))
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    cache_ex = jax.eval_shape(lambda: zoo.init_cache(1, kv_cache))
    arts = make_serve_step(zoo, mesh, {"tokens": jnp.zeros((1, 1), jnp.int32)},
                           rules_overrides={"batch": None, "kv_seq": "data"},
                           cache_example=cache_ex)
    p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    cache = jax.device_put(zoo.init_cache(1, kv_cache), arts.cache_sharding)
    prompt = inp[f"kv/{arch}/prompt"]
    for i in range(prompt.shape[1]):
        logits, cache = arts.decode_fn(p, cache, {"tokens": prompt[:, i:i + 1]})
        out[f"kv.{name}.decode{i}"] = np.asarray(logits)
    for k, v in flat(cache).items():
        out[f"kv.{name}.cache.{k}"] = np.asarray(v)
        if hasattr(v, "sharding") and v.ndim:
            out[f"kv.{name}.cache_spec.{k}"] = repr(tuple(v.sharding.spec))
np.savez(workdir + "/jax.npz", **out)
"""


def _inputs():
    out = {}
    rng = np.random.RandomState(0)
    archs = (*worlds.TP_ARCHS, worlds.MOE_ARCH)
    for arch in archs:
        cfg = jax_smoke(arch)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
        for i in range(worlds.TP_STEPS):
            batch = data.batch(i)
            if cfg.family == "whisper":
                batch["enc_embeds"] = rng.randn(B, S_ENC, cfg.d_model).astype(np.float32)
            if cfg.family == "vlm":
                batch["positions3"] = _grid3(B, S, 3)
            out.update({f"tp/{arch}/{i}/{k}": v for k, v in batch.items()})
    for arch in ("llama3.2-3b", "zamba2-7b"):
        out[f"kv/{arch}/prompt"] = rng.randint(0, jax_smoke(arch).vocab, (1, 7)).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process, then the port's world."""
    work = tmp_path_factory.mktemp("tp_manual_hier")
    np.savez(work / "inputs.npz", **_inputs())
    init = {}
    for arch in (*worlds.TP_ARCHS, worlds.MOE_ARCH):
        jparams = jax_get_model(jax_smoke(arch)).init(jax.random.PRNGKey(0))
        init.update({f"{arch}.{k}": v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), dtype="float32", device="cpu").items()})
    np.savez(work / "params.npz", **init)
    cases = ",".join(f"{a}@{''.join(map(str, m))}" for a, m in JAX_TP_MESH.items())
    cmds = {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work),
                str(worlds.TP_STEPS), str(worlds.KV_CACHE), cases],
        "tp": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "tp", str(RANKS),
               str(work)],
    }
    worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, RANKS))
    return {"jax": dict(np.load(work / "jax.npz")),
            "port": [dict(np.load(work / f"tp_{r}.npz")) for r in range(RANKS)]}


def _hist_close(got, want, tag_got, tag_want):
    np.testing.assert_allclose(got[f"{tag_got}.loss"], want[f"{tag_want}.loss"],
                               atol=JAX_LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[f"{tag_got}.grad_norm"], want[f"{tag_want}.grad_norm"],
                               rtol=JAX_LOSS_ATOL, atol=0)


def _coord(r, shape):
    return dict(zip(("pod", "data", "model"), np.unravel_index(r, shape)))


@pytest.mark.parametrize("mesh", worlds.TP_MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", worlds.TP_ARCHS)
def test_tp_manual_hier_matches_jax(runs, arch, mesh):
    """Two manual_hier steps with TP on "model", as the reference's: loss
    and grad_norm at test_torch_dist_train.py's tolerances, the gathered
    params after them at test_torch_fsdp.py's; every rank reports the same
    numbers."""
    tag = f"tp.{arch}.{''.join(map(str, mesh))}"
    want, got = runs["jax"], runs["port"][0]
    _hist_close(got, want, tag, f"tp.{arch}")
    _assert_params_close(_tree(got, f"{tag}.param."), _tree(want, f"tp.{arch}.param."))
    for r in range(1, RANKS):
        for what in ("loss", "grad_norm"):
            np.testing.assert_array_equal(runs["port"][r][f"{tag}.{what}"], got[f"{tag}.{what}"])


@pytest.mark.parametrize("mesh", worlds.TP_MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", worlds.TP_ARCHS)
def test_tp_manual_hier_ranks_hold_their_model_blocks(runs, arch, mesh):
    """Each rank holds its "model" block of every leaf that the layout
    splits over "model" (1/|model| of it) and the whole of the rest; ranks
    along the DP axes hold the same blocks."""
    tag = f"tp.{arch}.{''.join(map(str, mesh))}"
    zoo = get_model(get_smoke_config(arch))
    lay = step_layout(zoo, _Mesh(dict(zip(("pod", "data", "model"), mesh))), "manual_hier")
    split = 0
    for r, port in enumerate(runs["port"]):
        c = _coord(r, mesh)
        for key, spec in lay.specs.items():
            local, whole = port[f"{tag}.local.{key}"], port[f"{tag}.param.{key}"]
            axes = {a for e in spec for a in entry_axes(e)}
            assert axes <= {"model"}, (key, spec)
            idx = []
            for d, n in enumerate(whole.shape):
                on = "model" in entry_axes(spec[d])
                k, m = (mesh[2], c["model"]) if on else (1, 0)
                idx.append(slice(m * n // k, (m + 1) * n // k))
            np.testing.assert_array_equal(local, whole[tuple(idx)], err_msg=f"{key} rank {r}")
            split += bool(axes) and r == 0
    assert split > 0


def test_tp_manual_hier_checkpoint_holds_whole_leaves(runs):
    """A checkpoint of the TP manual_hier run restores onto its layout to
    the same blocks, and its files hold the whole leaves, as a one-card
    run's do."""
    tag = "tp.llama3.2-3b.222"
    for port in runs["port"]:
        assert bool(port[f"{tag}.restored_equal"])
        assert bool(port[f"{tag}.ckpt_whole_equal"])


@pytest.mark.parametrize("name", list(worlds.OV_CASES))
def test_attention_overrides_steps_and_layouts_match_jax(runs, name):
    """gspmd_fsdp under the dry run's attention_overrides: the layout's
    specs are the reference's param shardings leaf by leaf, and the steps
    give its losses, grad norms and params."""
    want, got = runs["jax"], runs["port"][0]
    tag = f"ov.{name}"
    _hist_close(got, want, tag, tag)
    _assert_params_close(_tree(got, f"{tag}.param."), _tree(want, f"{tag}.param."))
    specs = {k[len(tag) + 6:]: str(v) for k, v in got.items() if k.startswith(f"{tag}.spec.")}
    ref = {k[len(tag) + 6:]: str(v) for k, v in want.items() if k.startswith(f"{tag}.spec.")}
    assert specs and set(specs) == set(ref)
    for k in ref:
        assert _norm_spec(specs[k]) == _norm_spec(ref[k]), (k, specs[k], ref[k])


def _norm_spec(text: str) -> tuple:
    """A spec's repr as a tuple of tuples of axis names (None -> ())."""
    spec = eval(text, {"None": None})  # noqa: S307 - our own reprs of tuples of names
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-8b", "granite-20b", "gemma3-4b",
                                  "qwen2-vl-2b", "whisper-large-v3", "zamba2-7b",
                                  "xlstm-125m", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)], ids=["pod1", "pod2"])
def test_layouts_under_attention_overrides_are_the_references(arch, kind, shape):
    """At full size on the production meshes, ``param_layout`` and
    ``cache_layout`` with the dry run's overrides give the reference's
    specs leaf by leaf (the rules, ``logical_spec_tree`` and
    ``sanitize_specs`` that its ``make_train_step`` / ``make_serve_step``
    apply)."""
    from repro.configs import get_config as jax_config

    axes = ("pod", "data", "model")[-len(shape):]
    sizes = dict(zip(axes, shape))
    zoo, jzoo = get_model(_port_config(arch)), jax_get_model(jax_config(arch))
    ov = attention_overrides(zoo.cfg, sizes["model"], kind)
    assert ov == jax_attention_overrides(jzoo.cfg, sizes["model"], kind)
    fake = type("M", (), {"shape": sizes})()
    rules = make_rules(axes, ov)
    want = flatten(jax_sanitize(logical_spec_tree(jzoo.param_specs(), rules),
                                jax.eval_shape(lambda: jzoo.init(jax.random.PRNGKey(0))), fake))
    got = param_layout(zoo, _Mesh(sizes), ov).specs
    assert set(got) == set(want)
    for k in want:
        assert _norm_spec(repr(got[k])) == _norm_spec(repr(tuple(want[k]))), k
    cache_ex = jax.eval_shape(lambda: jzoo.init_cache(128, 1024))
    want = flatten(jax_sanitize(logical_spec_tree(jzoo.cache_specs(), rules), cache_ex, fake))
    port_ex = zoo.init_cache(128, 1024, device="meta")
    got = cache_layout(zoo, _Mesh(sizes), port_ex, ov).specs
    for k in want:
        if k in got:
            assert _norm_spec(repr(got[k])) == _norm_spec(repr(tuple(want[k]))), k


class _Mesh:
    """The names and sizes of a mesh, all a layout's specs need."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def _port_config(arch):
    from repro_torch.configs import get_config

    return get_config(arch)


@pytest.mark.parametrize("name", list(worlds.MOE_AXES_CASES))
def test_moe_on_other_axes_matches_jax(runs, name):
    """moonshot-smoke's gspmd_fsdp with its experts split over "model", and
    on meshes without "data" (dense over the global batch, the global
    capacity): losses, grad norms, aux and params as the reference's."""
    want, got = runs["jax"], runs["port"][0]
    tag = f"moe.{name}"
    _hist_close(got, want, tag, tag)
    np.testing.assert_allclose(got[f"{tag}.aux"], want[f"{tag}.aux"], rtol=1e-4, atol=1e-6)
    _assert_params_close(_tree(got, f"{tag}.param."), _tree(want, f"{tag}.param."))
    # EP over "model" moves tokens by all-to-all; the dense layer does not
    assert (float(got[f"{tag}.a2a_bytes"]) > 0) == (name == "ep_model")


@pytest.mark.parametrize("name", list(worlds.KV_CASES))
def test_decode_over_a_cache_cut_by_position_matches_jax(runs, name):
    """Batch 1, the cache's positions cut over "data": every decode step's
    logits are the reference's on every rank, each rank's attention cache
    holds its block of positions of the reference's final cache, and the
    position cut is the reference's cache sharding."""
    want = runs["jax"]
    steps = [k for k in want if k.startswith(f"kv.{name}.decode")]
    assert len(steps) == 7
    arch, n = worlds.KV_CASES[name]
    key = "k" if arch == "llama3.2-3b" else "attn_k"
    assert _norm_spec(str(want[f"kv.{name}.cache_spec.{key}"]))[2] == ("data",)
    for r, port in enumerate(runs["port"]):
        for k in steps:
            np.testing.assert_allclose(port[k], want[k], **F32, err_msg=f"{k} rank {r}")
        d = r % n
        for leaf in (key, key.replace("k", "v")):
            whole = want[f"kv.{name}.cache.{leaf}"]
            L = whole.shape[2] // n
            np.testing.assert_allclose(port[f"kv.{name}.cache.{leaf}"],
                                       whole[:, :, d * L:(d + 1) * L], **F32,
                                       err_msg=f"{leaf} rank {r}")
