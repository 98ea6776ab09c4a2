"""The port's expert-parallel MoE against the JAX package's, rank by rank:
``moe_ffn_ep`` (outputs, aux and gradients) on a (4,) "data" mesh, on (2, 2)
("data", "model") and on (2, 2) with ``token_scatter``; the ``gspmd_fsdp``
step of moonshot-smoke on (2, 2, 2) with EP over "data" and TP over
"model"; sharded decode on (4, 2).

The port runs in one gloo world of 8 ranks (``torch_dist_worlds.moe_ep``),
JAX in its own process on 8 forced host devices, one after the other
(``torch_dist_worlds.run_in_turn``).  Sharded MoE is held against JAX's
sharded MoE on the same mesh, never against the one-device form: the EP
capacity is a rank's (from its tokens, rounded up to a multiple of
|model|), the dense one the global batch's, so where capacity binds they
drop different tokens (the reference's own sharded decode differs from its
one-device decode)."""

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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import DTypes  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402

RANKS = 8
ARCH = worlds.MOE_ARCH
FSDP_MESH = ((2, 2, 2), ("pod", "data", "model"))
# the reference's own bound on its train modes (tests/test_distributed.py)
JAX_LOSS_ATOL = 1e-3
# one MoE layer in f32, routed alike on both sides: sums in another order
LAYER = dict(atol=1e-5, rtol=1e-5)
# f32 logits of two layers (test_torch_serve.py, test_torch_fsdp.py)
F32 = dict(atol=1e-4, rtol=1e-4)
# EP against dense where capacity does not bind (tests/test_distributed.py)
EP_DENSE_ATOL = 2e-4

JAX_SIDE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.common import DTypes
from repro.models.model_zoo import get_model
from repro.models.moe import MoEConfig, moe_ffn_ep
from repro.serve.serve_step import make_serve_step
from repro.train.optimizer import AdamWConfig, init as opt_init
from repro.train.train_step import make_train_step

workdir, steps, arch = sys.argv[1], int(sys.argv[2]), sys.argv[3]
slots, cache_len, cases = int(sys.argv[4]), int(sys.argv[5]), json.loads(sys.argv[6])
inp = np.load(workdir + "/inputs.npz")
out = {}

dt = DTypes()
p = {"router": {"w": jnp.asarray(inp["moe.router"])},
     **{k: jnp.asarray(inp["moe." + k]) for k in ("wi", "wg", "wo")}}
x, ct = jnp.asarray(inp["moe.x"]), jnp.asarray(inp["moe.ct"])
for name, (shape, axes, scatter, cf) in cases.items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(axes))
    cfg = MoEConfig(d_model=32, d_ff=16, num_experts=8, top_k=2, capacity_factor=cf,
                    token_scatter=scatter)

    def f(p, x):
        y, aux = moe_ffn_ep(p, cfg, x, dt, mesh)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(p, x)
    out.update({f"{name}.y": y, f"{name}.aux": aux, f"{name}.g.x": gx,
                f"{name}.g.router": gp["router"]["w"],
                **{f"{name}.g.{k}": gp[k] for k in ("wi", "wg", "wo")}})

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

zoo = get_model(get_smoke_config(arch))
batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]} for i in range(steps)]
ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
arts = make_train_step(zoo, ocfg, mesh, batches[0])
params = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
opt = jax.device_put(opt_init(ocfg, zoo.init(jax.random.PRNGKey(0))), arts.opt_sharding)
hist = {"loss": [], "aux": [], "grad_norm": []}
for b in batches:
    params, opt, m = arts.step_fn(params, opt, {k: jax.device_put(v, arts.batch_sharding[k])
                                                for k, v in b.items()})
    for k in hist:
        hist[k].append(float(m[k]))
out.update({f"fsdp.{k}": v for k, v in hist.items()})
shard = flat(arts.param_sharding)
for k, v in flat(params).items():
    out[f"fsdp.param.{k}"] = np.asarray(v)
    out[f"fsdp.block.{k}"] = blocks(mesh, shard[k], v.shape)

mesh = make_mesh((4, 2), ("data", "model"))
cache_ex = jax.eval_shape(lambda: zoo.init_cache(slots, cache_len))
arts = make_serve_step(zoo, mesh, {"tokens": jnp.zeros((slots, 1), jnp.int32)},
                       cache_example=cache_ex)
params = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
cache = jax.device_put(zoo.init_cache(slots, cache_len), arts.cache_sharding)
prompt = inp["prompt"]
out["serve.prefill"] = arts.prefill_fn(params, {"tokens": prompt})
for i in range(prompt.shape[1]):
    logits, cache = arts.decode_fn(params, cache, {"tokens": prompt[:, i:i + 1]})
    out[f"serve.decode{i}"] = logits
np.savez(workdir + "/jax.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


def _jax_cases():
    """MOE_EP_CASES without the port's "rep" axis: the JAX meshes."""
    out = {}
    for name, (shape, axes, scatter, cf) in worlds.MOE_EP_CASES.items():
        keep = [i for i, a in enumerate(axes) if a != "rep"]
        out[name] = [[shape[i] for i in keep], [axes[i] for i in keep], scatter, cf]
    return out


def _inputs():
    cfg = get_smoke_config(ARCH)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8))
    out = {f"{k}{i}": v for i in range(worlds.TRAIN_STEPS) for k, v in data.batch(i).items()}
    rng = np.random.RandomState(0)
    out["prompt"] = rng.randint(0, cfg.vocab, (worlds.SERVE_SLOTS, 7)).astype(np.int64)
    lc = worlds.moe_layer_config()
    D, F, E = lc.d_model, lc.d_ff, lc.num_experts
    out["moe.x"] = rng.randn(8, 4, D).astype(np.float32)
    out["moe.ct"] = rng.randn(8, 4, D).astype(np.float32)
    out["moe.router"] = (rng.randn(D, E) / np.sqrt(D)).astype(np.float32)
    out["moe.wi"] = (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32)
    out["moe.wg"] = (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32)
    out["moe.wo"] = (rng.randn(E, F, D) / np.sqrt(F)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process, then the port's world of 8."""
    work = tmp_path_factory.mktemp("moe_ep")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    jparams = jax_get_model(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32",
                           device="cpu")
    np.savez(work / "params.npz", **{f"{ARCH}.{k}": v.numpy() for k, v in init.items()})
    cmds = {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work),
                str(worlds.TRAIN_STEPS), ARCH, str(worlds.SERVE_SLOTS), str(worlds.SERVE_CACHE),
                json.dumps(_jax_cases())],
        "moe_ep": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "moe_ep",
                   str(RANKS), str(work)],
    }
    worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, RANKS))
    return {
        "inputs": inputs,
        "jax": dict(np.load(work / "jax.npz")),
        "port": [dict(np.load(work / f"moe_ep_{r}.npz")) for r in range(RANKS)],
    }


def _coords(shape, axes):
    """{axis: coordinate} of each rank of a mesh of ``shape``."""
    return [dict(zip(axes, (int(c) for c in np.unravel_index(r, shape)))) for r in range(RANKS)]


def _case_blocks(name):
    """Per rank: the rows of x, and the expert / F slices, of its block."""
    shape, axes, _, _ = worlds.MOE_EP_CASES[name]
    n_data = shape[axes.index("data")]
    n_tp = shape[axes.index("model")] if "model" in axes else 1
    lc = worlds.moe_layer_config()
    out = []
    for c in _coords(shape, axes):
        d, m = c["data"], c.get("model", 0)
        rows, E, F = 8 // n_data, lc.num_experts // n_data, lc.d_ff // n_tp
        out.append((slice(d * rows, (d + 1) * rows), slice(d * E, (d + 1) * E),
                    slice(m * F, (m + 1) * F)))
    return out


@pytest.mark.parametrize("name", ["data4", "dm22", "dm22_scatter"])
def test_moe_ffn_ep_matches_jax_rank_by_rank(runs, name):
    """Each rank's output rows, aux, and the gradients of sum(y * ct) + aux:
    x's rows, its expert blocks', and the router's summed over "data", as
    JAX's moe_ffn_ep on the same mesh (EP over "data", F over "model",
    token_scatter's reduce-scatter and re-gathers)."""
    want = runs["jax"]
    for port, (rows, es, fs) in zip(runs["port"], _case_blocks(name)):
        np.testing.assert_allclose(port[f"{name}.y"], want[f"{name}.y"][rows], **LAYER)
        np.testing.assert_allclose(port[f"{name}.aux"], want[f"{name}.aux"], rtol=1e-6)
        np.testing.assert_allclose(port[f"{name}.g.x"], want[f"{name}.g.x"][rows], **LAYER)
        np.testing.assert_allclose(port[f"{name}.g.router"], want[f"{name}.g.router"], **LAYER)
        np.testing.assert_allclose(port[f"{name}.g.wi"], want[f"{name}.g.wi"][es, :, fs], **LAYER)
        np.testing.assert_allclose(port[f"{name}.g.wg"], want[f"{name}.g.wg"][es, :, fs], **LAYER)
        np.testing.assert_allclose(port[f"{name}.g.wo"], want[f"{name}.g.wo"][es, fs, :], **LAYER)


def test_moe_ffn_ep_equals_dense_where_capacity_does_not_bind(runs):
    """Capacity factor 8 on (4,): no token dropped, so EP is the dense
    oracle (mirror of tests/test_distributed.py::test_moe_ep_matches_dense)."""
    inp = runs["inputs"]
    lc = worlds.moe_layer_config(capacity_factor=8.0)
    p = {"router": {"w": torch.from_numpy(inp["moe.router"])},
         **{k: torch.from_numpy(inp[f"moe.{k}"]) for k in ("wi", "wg", "wo")}}
    dense, _ = moe.moe_ffn_dense(p, lc, torch.from_numpy(inp["moe.x"]), DTypes())
    for port, (rows, _, _) in zip(runs["port"], _case_blocks("data4_loose")):
        got = port["data4_loose.y"]
        assert np.abs(got - dense.numpy()[rows]).max() < EP_DENSE_ATOL


@pytest.mark.parametrize("name", ["data4", "dm22", "dm22_scatter"])
def test_all_to_all_bytes_are_the_reckoning(runs, name):
    """Two all-to-alls forward (dispatch, combine) and two backward, each of
    E x C x D f32 a rank, with C the rank's capacity (its T = 8 or 16
    tokens; rounded up to |model| = 2 with TP; a 1/|model| slice of it with
    token_scatter); nothing crosses "data" but those and aux's scalar."""
    shape, axes, scatter, cf = worlds.MOE_EP_CASES[name]
    lc = worlds.moe_layer_config(scatter, cf)
    n_data = shape[axes.index("data")]
    tp = shape[axes.index("model")] if "model" in axes else 1
    cap = moe.capacity(lc, (8 // n_data) * 4)
    cap = -(-cap // tp) * tp
    assert cap == {"data4": 2, "dm22": 6, "dm22_scatter": 6}[name]  # round(2.5) = 2
    queue = lc.num_experts * (cap // tp if scatter else cap) * lc.d_model * 4
    for port in runs["port"]:
        recs = list(zip(port[f"{name}.ledger.op"], port[f"{name}.ledger.axes"],
                        (int(n) for n in port[f"{name}.ledger.bytes"])))
        a2a = [n for op, _, n in recs if op == "all_to_all"]
        assert a2a == [queue] * 4
        assert [(op, n) for op, ax, n in recs if "data" in ax.split(",") and op != "all_to_all"] \
            == [("all_reduce", 4)]


def test_gspmd_fsdp_with_ep_matches_jax(runs):
    """Three gspmd_fsdp steps of moonshot-smoke on (2, 2, 2): loss, aux and
    grad_norm within the reference's bound of JAX's; the gathered params
    after them at the dense family's; every rank reports the same."""
    want, got = runs["jax"], runs["port"][0]
    for what in ("loss", "aux"):
        np.testing.assert_allclose(got[f"fsdp.{what}"], want[f"fsdp.{what}"],
                                   atol=JAX_LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got["fsdp.grad_norm"], want["fsdp.grad_norm"],
                               rtol=JAX_LOSS_ATOL, atol=0)
    assert got["fsdp.loss"][-1] < got["fsdp.loss"][0] and min(got["fsdp.aux"]) > 0
    for k in (k for k in want if k.startswith("fsdp.param.")):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3, err_msg=k)
    for port in runs["port"][1:]:
        for what in ("loss", "aux", "grad_norm"):
            np.testing.assert_array_equal(port[f"fsdp.{what}"], got[f"fsdp.{what}"])


def test_expert_blocks_sit_as_jax_named_sharding(runs):
    """Every param leaf a rank holds, the expert leaves (E over "data", F
    over "model") among them, is the block of JAX's NamedSharding at that
    rank's mesh coordinate."""
    want = runs["jax"]
    keys = [k[len("fsdp.local."):] for k in runs["port"][0] if k.startswith("fsdp.local.")]
    assert {"layers.moe.wi", "layers.moe.wg", "layers.moe.wo", "layers.moe.router.w"} <= set(keys)
    for r, port in enumerate(runs["port"]):
        for leaf in keys:
            idx = want[f"fsdp.block.{leaf}"][r]
            block = port[f"fsdp.param.{leaf}"][tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_array_equal(port[f"fsdp.local.{leaf}"], block,
                                          err_msg=f"{leaf} rank {r}")
        L, E, D, F = port["fsdp.param.layers.moe.wi"].shape
        assert port["fsdp.local.layers.moe.wi"].shape == (L, E // 2, D, F // 2)


def test_experts_are_never_gathered_over_data(runs):
    """One step's byte ledger on (2, 2, 2): the all-gathers over "data" are
    those of the non-expert leaves alone (the forward's FSDP gathers of the
    layer leaves split over "data", once each: smoke runs no remat; the
    gradient's Eq. 8 all-gather of the leaves whole over it), and the
    all-to-alls are the reckoning: per
    layer 2 forward + 2 backward of E x C x D f32, C = round(1.25 * 32 * 2
    / 4) = 20 (a rank's 2 rows of 16 tokens; 20 divides by |model|)."""
    zoo = get_model(get_smoke_config(ARCH))
    cfg = zoo.cfg
    lay = S.param_layout(zoo, types.SimpleNamespace(shape=FSDP_MESH[0],
                                                    mesh_dim_names=FSDP_MESH[1]))
    n_data = FSDP_MESH[0][1]
    port = runs["port"][0]
    experts = {"layers.moe.wi", "layers.moe.wg", "layers.moe.wo"}
    others, on_data = 0, set()
    for key, spec in lay.specs.items():
        n = port[f"fsdp.local.{key}"].size
        if "data" in {a for e in spec for a in S.entry_axes(e)}:
            on_data.add(key)
            if key not in experts:  # the forward's FSDP gather
                others += n * n_data * 4
        else:  # the gradient's Eq. 8 all-gather phase, padded to |data|
            others += -(-n // n_data) * n_data * 4
    assert experts < on_data
    recs = list(zip(port["fsdp.ledger.op"], port["fsdp.ledger.axes"],
                    (int(n) for n in port["fsdp.ledger.bytes"])))
    gathered = sum(n for op, ax, n in recs if op == "all_gather" and "data" in ax.split(","))
    assert gathered == others > 0
    from repro_torch.models.transformer import _moe_cfg

    cap = moe.capacity(_moe_cfg(cfg), 32)
    assert cap == 20 and cap % FSDP_MESH[0][2] == 0
    queue = cfg.moe.num_experts * cap * cfg.d_model * 4
    assert [n for op, _, n in recs if op == "all_to_all"] == [queue] * (4 * cfg.num_layers)


def test_manual_hier_refuses_moe(runs):
    """The reference cannot run manual_hier with MoE layers (its EP
    shard_map cannot nest in the manual region): the port raises."""
    for port in runs["port"]:
        assert "manual_hier" in str(port["refuse.manual_hier"])
        assert "gspmd_fsdp" in str(port["refuse.manual_hier"])


def test_launcher_refuses_manual_hier_with_moe():
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match="manual_hier"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--devices", "8", "--mesh", "2,2,2",
              "--axes", "pod,data,model", "--dp-mode", "manual_hier"])


def test_sharded_decode_matches_jax_sharded_decode(runs):
    """make_serve_step(mesh=) on (4, 2): prefill and each one-token decode
    step give JAX's sharded serve step's whole logits on every rank (EP
    with a rank's capacity), the experts held one a data rank."""
    want = runs["jax"]
    for port in runs["port"]:
        assert port["serve.local.wi"].shape[1:] == (1, 64, 48)
        np.testing.assert_allclose(port["serve.prefill"], want["serve.prefill"], **F32)
        steps = [k for k in want if k.startswith("serve.decode")]
        assert len(steps) == 7
        for k in steps:
            np.testing.assert_allclose(port[k], want[k], **F32, err_msg=k)
