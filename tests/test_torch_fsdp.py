"""The port's sharded step (``gspmd_fsdp``: FSDP over "data", tensor
parallelism over "model") and sharded serving against the JAX package's,
rank by rank.

The dense smoke configs on a (2, 2, 2) ("pod", "data", "model") world of 8
gloo ranks (``torch_dist_worlds.fsdp``) start from the JAX init at
``PRNGKey(0)`` carried over by ``interop.params_from_jax``; JAX runs the
reference's ``gspmd_fsdp`` step and its sharded ``make_serve_step`` in its
own process on 8 forced host devices.  The two run one after the other,
each with a time limit (``torch_dist_worlds.run_in_turn``)."""

import math
import os
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402
from test_torch_train import LOSS, _assert_params_close  # noqa: E402

RANKS = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
# the reference's own bound on its two train modes (tests/test_distributed.py)
JAX_LOSS_ATOL = 1e-3
# f32 logits of one function summed in another order (test_torch_serve.py)
F32 = dict(atol=1e-4, rtol=1e-4)

JAX_SIDE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import get_model
from repro.serve.serve_step import make_serve_step
from repro.train.optimizer import AdamWConfig, init as opt_init
from repro.train.train_step import make_train_step

workdir, steps = sys.argv[1], int(sys.argv[2])
archs, serve_archs = sys.argv[3].split(","), sys.argv[4].split(",")
slots, cache_len = int(sys.argv[5]), int(sys.argv[6])
inp = np.load(workdir + "/inputs.npz")
batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]} for i in range(steps)]
ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
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
    return np.array([[[s.start or 0, shape[d] if s.stop is None else s.stop]
                      for d, s in enumerate(idx[mesh.devices[c]])]
                     for c in np.ndindex(*mesh.devices.shape)])

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
for arch in archs:
    zoo = get_model(get_smoke_config(arch))
    for micro in ((1, 2) if arch == "llama3.2-3b" else (1,)):
        arts = make_train_step(zoo, ocfg, mesh, batches[0], microbatches=micro)
        p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
        o = jax.device_put(opt_init(ocfg, zoo.init(jax.random.PRNGKey(0))), arts.opt_sharding)
        losses, gnorms = [], []
        for b in batches:
            p, o, m = arts.step_fn(p, o, {k: jax.device_put(v, arts.batch_sharding[k])
                                          for k, v in b.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[f"{arch}.mb{micro}.loss"], out[f"{arch}.mb{micro}.grad_norm"] = losses, gnorms
        if micro == 1:
            shard = flat(arts.param_sharding)
            for k, v in flat(p).items():
                out[f"{arch}.param.{k}"] = np.asarray(v)
                out[f"{arch}.block.{k}"] = blocks(mesh, shard[k], v.shape)
            for k, v in flat(o.mu).items():
                out[f"{arch}.mu_block.{k}"] = blocks(mesh, flat(arts.opt_sharding.mu)[k], v.shape)

mesh = make_mesh((4, 2), ("data", "model"))
prompt = inp["prompt"]
for arch in serve_archs:
    zoo = get_model(get_smoke_config(arch))
    cache_ex = jax.eval_shape(lambda: zoo.init_cache(slots, cache_len))
    arts = make_serve_step(zoo, mesh, {"tokens": jnp.zeros((slots, 1), jnp.int32)},
                           cache_example=cache_ex)
    p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    cache = jax.device_put(zoo.init_cache(slots, cache_len), arts.cache_sharding)
    out[f"serve.{arch}.cache_shape"] = np.array(
        arts.cache_sharding["k"].shard_shape(cache_ex["k"].shape))
    out[f"serve.{arch}.prefill"] = np.asarray(arts.prefill_fn(p, {"tokens": prompt}))
    for i in range(prompt.shape[1]):
        logits, cache = arts.decode_fn(p, cache, {"tokens": prompt[:, i:i + 1]})
        out[f"serve.{arch}.decode{i}"] = np.asarray(logits)
np.savez(workdir + "/jax.npz", **out)
"""


def _inputs(cfg):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8))
    out = {f"{k}{i}": v for i in range(worlds.TRAIN_STEPS) for k, v in data.batch(i).items()}
    rng = np.random.RandomState(0)
    out["mask"] = (rng.rand(8, 16) < 0.6).astype(np.float32)
    out["prompt"] = rng.randint(0, cfg.vocab, (worlds.SERVE_SLOTS, 7)).astype(np.int64)
    return out


def _jax_init(arch):
    jparams = jax_get_model(jax_smoke(arch)).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32",
                           device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process, then the port's (2, 2, 2) world."""
    work = tmp_path_factory.mktemp("fsdp")
    inputs = _inputs(get_smoke_config("llama3.2-3b"))
    np.savez(work / "inputs.npz", **inputs)
    init = {arch: _jax_init(arch) for arch in worlds.FSDP_ARCHS}
    np.savez(work / "params.npz", **{f"{a}.{k}": v.numpy() for a, st in init.items()
                                     for k, v in st.items()})
    cmds = {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work),
                str(worlds.TRAIN_STEPS), ",".join(worlds.FSDP_ARCHS),
                ",".join(worlds.SERVE_ARCHS), str(worlds.SERVE_SLOTS), str(worlds.SERVE_CACHE)],
        "fsdp": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "fsdp", str(RANKS),
                 str(work)],
    }
    worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, RANKS))
    return {
        "work": work,
        "inputs": inputs,
        "init": init,
        "jax": dict(np.load(work / "jax.npz")),
        "port": [dict(np.load(work / f"fsdp_{r}.npz")) for r in range(RANKS)],
    }


def _tree(out, prefix):
    n = len(prefix)
    return {k[n:]: torch.from_numpy(v) for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("arch", worlds.FSDP_ARCHS)
def test_gspmd_fsdp_matches_jax(runs, arch):
    """Three gspmd_fsdp steps (the default dp_mode) on (2, 2, 2), as the
    reference's; the gathered params after them at test_torch_train's
    tolerances; every rank reports the same global numbers."""
    want, got = runs["jax"], runs["port"][0]
    np.testing.assert_allclose(got[f"{arch}.gspmd.loss"], want[f"{arch}.mb1.loss"],
                               atol=JAX_LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[f"{arch}.gspmd.grad_norm"], want[f"{arch}.mb1.grad_norm"],
                               rtol=JAX_LOSS_ATOL, atol=0)
    assert got[f"{arch}.gspmd.loss"][-1] < got[f"{arch}.gspmd.loss"][0]
    _assert_params_close(_tree(got, f"{arch}.param."), _tree(want, f"{arch}.param."))
    for r in range(1, RANKS):
        for what in ("loss", "grad_norm"):
            np.testing.assert_array_equal(runs["port"][r][f"{arch}.gspmd.{what}"],
                                          got[f"{arch}.gspmd.{what}"])


@pytest.mark.parametrize("arch", worlds.FSDP_ARCHS)
def test_blocks_sit_as_jax_named_sharding(runs, arch):
    """Every param and AdamW-moment leaf on each rank is the block that the
    reference's NamedSharding gives that rank's mesh coordinate (granite's
    single KV head split on its Hk * Dh dim), and DTensor's placements of
    the spec give the same blocks."""
    want = runs["jax"]
    coords = list(np.ndindex(*MESH[0]))
    for r, port in enumerate(runs["port"]):
        assert bool(port[f"{arch}.dtensor_blocks"])
        assert coords[r] == tuple(int(c) for c in np.unravel_index(r, MESH[0]))
        for kind, local, whole in (("block", "local", "param"), ("mu_block", "local_mu", "mu")):
            keys = [k for k in port if k.startswith(f"{arch}.{local}.")]
            assert keys
            for k in keys:
                leaf = k[len(f"{arch}.{local}."):]
                idx = want[f"{arch}.{kind}.{leaf}"][r]
                block = port[f"{arch}.{whole}.{leaf}"][tuple(slice(a, b) for a, b in idx)]
                np.testing.assert_array_equal(port[k], block, err_msg=f"{k} rank {r}")


def test_granite_stores_its_kv_head_split_over_model(runs):
    """kv_heads = 1: wk / wv keep the reference's (stack, data, model) split
    of their (L, D, Hk * Dh) shape; no rank holds the whole head."""
    port = runs["port"][0]
    cfg = get_smoke_config("granite-20b")
    L, D, dh = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    for leaf in ("wk", "wv"):
        assert port[f"granite-20b.local.layers.attn.{leaf}.w"].shape == (L, D // 2, dh // 2)


@pytest.mark.parametrize("name", list(worlds.ODD_CASES))
def test_other_model_layouts_match_the_one_process_step(runs, name):
    """Attention whole on every rank (heads that do not divide "model"),
    and KV heads picked per rank (query heads a rank that neither divide
    nor are divided by the KV group): three steps against the port's own
    one-process step, held against JAX in test_torch_train.py, at its
    tolerances."""
    zoo = get_model(worlds.odd_config(name))
    plan = zoo.shard_plan(S.param_layout(zoo, types.SimpleNamespace(
        shape=worlds.ODD_CASES[name][2], mesh_dim_names=MESH[1])))
    assert (plan.heads, plan.kv) == ({"whole_heads": (False, False),
                                      "kv_select": (True, False)}[name])
    ocfg = opt_lib.AdamWConfig(**worlds.OCFG)
    params = zoo.init(0, device="cpu")
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    step_fn = make_train_step(zoo, ocfg, device="cpu")
    got = runs["port"][0]
    inputs = runs["inputs"]
    for i in range(worlds.TRAIN_STEPS):
        batch = {"tokens": inputs[f"tokens{i}"], "targets": inputs[f"targets{i}"]}
        params, opt, m = step_fn(params, opt, batch)
        np.testing.assert_allclose(got[f"odd.{name}.loss"][i], float(m["loss"]), **LOSS)
        np.testing.assert_allclose(got[f"odd.{name}.grad_norm"][i], float(m["grad_norm"]),
                                   **LOSS)
    _assert_params_close(_tree(got, f"odd.{name}.param."), params.state_dict())


def test_gspmd_fsdp_agrees_with_manual_hier(runs):
    """The port's two modes on (2, 2, 2), mirroring tests/test_distributed.py
    ::test_train_modes_agree."""
    port = runs["port"][0]
    a, b = port["llama3.2-3b.gspmd.loss"], port["llama3.2-3b.manual.loss"]
    assert all(abs(x - y) < JAX_LOSS_ATOL for x, y in zip(a, b)), (a, b)
    assert a[-1] < a[0]


def test_microbatched_gspmd_fsdp_matches_jax(runs):
    port, want = runs["port"][0], runs["jax"]
    np.testing.assert_allclose(port["llama3.2-3b.mb2.loss"], want["llama3.2-3b.mb2.loss"],
                               atol=JAX_LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(port["llama3.2-3b.mb2.grad_norm"],
                               want["llama3.2-3b.mb2.grad_norm"], rtol=JAX_LOSS_ATOL, atol=0)


def test_only_data_shards_of_gradients_cross_pod(runs):
    """One step's byte ledger: every collective over "pod" carries at most
    a 1/|data| shard of a leaf's model-local gradient (f32), and together
    they carry 1/|data| of them all, plus the loss's two scalars."""
    data = MESH[0][1]
    port = runs["port"][0]
    local = {k[len("llama3.2-3b.local."):]: v for k, v in port.items()
             if k.startswith("llama3.2-3b.local.")}
    layout = S.param_layout(get_model(get_smoke_config("llama3.2-3b")),
                            types.SimpleNamespace(shape=MESH[0], mesh_dim_names=MESH[1]))
    shards = []
    for k, v in local.items():
        split = "data" in {a for e in layout.specs[k] for a in S.entry_axes(e)}
        elems = v.size if split else math.ceil(v.size / data)
        shards.append(4 * elems)
    pod = [(op, int(n)) for op, axes, n in zip(port["ledger.op"], port["ledger.axes"],
                                               port["ledger.bytes"]) if "pod" in axes.split(",")]
    assert pod and all(op == "all_reduce" for op, _ in pod)
    assert max(n for _, n in pod) <= max(shards)
    assert sum(n for _, n in pod) == sum(shards) + 8
    # nothing else of the step crosses pod: the forward and backward
    # collectives run over "data" and "model" only
    assert len(pod) == len(shards) + 1


def test_global_masked_loss(runs):
    """With a loss mask the sharded loss is the global masked sum over the
    global mask sum, not a mean of per-rank ratios."""
    inputs = runs["inputs"]
    zoo = get_model(get_smoke_config("llama3.2-3b"))
    params = ParamTree.from_state_dict(runs["init"]["llama3.2-3b"])
    batch = {"tokens": torch.from_numpy(inputs["tokens0"]),
             "targets": torch.from_numpy(inputs["targets0"]),
             "loss_mask": torch.from_numpy(inputs["mask"])}
    with torch.no_grad():
        want, _ = zoo.loss(params, batch)
    for port in runs["port"]:
        np.testing.assert_allclose(float(port["masked_loss"]), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", worlds.SERVE_ARCHS)
def test_sharded_decode_matches_jax(runs, arch):
    """make_serve_step(mesh=) on (4, 2) ("data", "model"), as
    examples/serve_decode.py: prefill and each one-token decode step give
    the reference's whole logits on every rank, and the cache is sharded as
    its cache_sharding."""
    want = runs["jax"]
    for port in runs["port"]:
        np.testing.assert_array_equal(port[f"serve.{arch}.cache_shape"],
                                      want[f"serve.{arch}.cache_shape"])
        np.testing.assert_allclose(port[f"serve.{arch}.prefill"], want[f"serve.{arch}.prefill"],
                                   **F32)
        steps = [k for k in want if k.startswith(f"serve.{arch}.decode")]
        assert len(steps) == 7 and int(port[f"serve.{arch}.index"]) == 7
        for k in steps:
            np.testing.assert_allclose(port[k], want[k], **F32, err_msg=k)


def _jax_like():
    zoo = jax_get_model(jax_smoke("llama3.2-3b"))
    params = jax.eval_shape(lambda: zoo.init(jax.random.PRNGKey(0)))
    return {"params": params,
            "opt": jax.eval_shape(lambda p: jax_opt.init(jax_opt.AdamWConfig(), p), params)}


def test_sharded_checkpoint_restores_in_both_packages(runs):
    """The (2, 2, 2) world's checkpoint holds whole leaves: JAX's restore
    and the port's one-process restore both give the gathered params and
    moments."""
    d = str(runs["work"] / "ckpt")
    port = runs["port"][0]
    want_p = _tree(port, "llama3.2-3b.param.")
    want_mu = _tree(port, "llama3.2-3b.mu.")
    tree, extra = jax_ckpt.restore(d, _jax_like())
    assert extra == {"step": worlds.TRAIN_STEPS}
    got = S.flatten(jax.tree_util.tree_map(np.asarray, tree["params"]))
    got_mu = S.flatten(jax.tree_util.tree_map(np.asarray, tree["opt"].mu))
    assert set(got) == set(want_p) and int(tree["opt"].step) == worlds.TRAIN_STEPS
    for k in want_p:
        np.testing.assert_array_equal(got[k], want_p[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(got_mu[k], want_mu[k].numpy(), err_msg=k)
    zoo = get_model(get_smoke_config("llama3.2-3b"))
    like = zoo.init(0, device="cpu")
    ocfg = opt_lib.AdamWConfig(**worlds.OCFG)
    tree, _ = ckpt.restore(d, {"params": like, "opt": opt_lib.init(ocfg, like)})
    for k, v in tree["params"].state_dict().items():
        assert torch.equal(v, want_p[k]), k
        assert torch.equal(tree["opt"].mu[k], want_mu[k]), k
    assert tree["opt"].step == worlds.TRAIN_STEPS
