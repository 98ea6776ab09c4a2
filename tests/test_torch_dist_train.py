"""The port's distributed ``manual_hier`` train step against the JAX
package and against its own one-process step; the mesh helpers; the
launcher's spawned CPU world.

The smoke llama3.2-3b config on a (2, 2, 2) ("pod", "data", "model") world
of 8 gloo ranks (``torch_dist_worlds.py``) starts from the JAX init at
``PRNGKey(0)`` carried over by ``interop.params_from_jax``; JAX runs the
reference's step in its own process on 8 forced host devices.  The
processes run one after another, each with a time limit
(``torch_dist_worlds.run_in_turn``)."""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.mapping import (  # noqa: E402
    ModelSpec, ParallelismPlan, WorkloadShape, plan_dimension_split,
)
from repro.core.topology import RailXConfig  # noqa: E402
from repro.launch.mesh import railx_mesh_from_plan as jax_mesh_from_plan  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import railx_mesh_from_plan  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import make_train_step, step_layout  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402
from test_torch_train import LOSS, _assert_params_close  # noqa: E402

SRC = os.path.join(HERE, "..", "src")
ARCH = "llama3.2-3b"
RANKS = 8
SCHEDULES = ("flat", "hierarchical", "compressed")
# the reference's own bound on its two train modes (tests/test_distributed.py)
JAX_LOSS_ATOL = 1e-3

JAX_SIDE = """
import sys
import numpy as np, jax
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import get_model
from repro.train.optimizer import AdamWConfig, init as opt_init
from repro.train.train_step import make_train_step

workdir, steps = sys.argv[1], int(sys.argv[2])
inp = np.load(workdir + "/inputs.npz")
batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]} for i in range(steps)]
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
zoo = get_model(get_smoke_config("llama3.2-3b"))
ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
out = {}
for sched in ("flat", "hierarchical", "compressed"):
    arts = make_train_step(zoo, ocfg, mesh, batches[0], dp_mode="manual_hier", schedule=sched)
    p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    o = jax.device_put(opt_init(ocfg, zoo.init(jax.random.PRNGKey(0))), arts.opt_sharding)
    losses, gnorms = [], []
    for b in batches:
        p, o, m = arts.step_fn(p, o, {k: jax.device_put(v, arts.batch_sharding[k])
                                      for k, v in b.items()})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    out[f"{sched}.loss"], out[f"{sched}.grad_norm"] = losses, gnorms
np.savez(workdir + "/jax.npz", **out)
"""


def _batches(cfg, steps):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8))
    return [data.batch(i) for i in range(steps)]


def _init_state():
    jparams = jax_get_model(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32",
                           device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process, the (2, 2, 2) world, the world of one and the
    launcher's spawned world, one after another."""
    work = tmp_path_factory.mktemp("dist_train")
    cfg = get_smoke_config(ARCH)
    batches = _batches(cfg, worlds.TRAIN_STEPS)
    np.savez(work / "inputs.npz", **{f"{k}{i}": v for i, b in enumerate(batches)
                                     for k, v in b.items()})
    state = _init_state()
    np.savez(work / "params.npz", **{k: v.numpy() for k, v in state.items()})
    script = os.path.join(HERE, "torch_dist_worlds.py")
    cmds = {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work),
                str(worlds.TRAIN_STEPS)],
        "train": [sys.executable, script, "train", str(RANKS), str(work)],
        "one": [sys.executable, script, "one", "1", str(work)],
        "launch": [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device",
                   "cpu", "--devices", str(RANKS), "--mesh", "2,2,2", "--axes",
                   "pod,data,model", "--dp-mode", "manual_hier", "--schedule",
                   "hierarchical", "--steps", "3", "--seq-len", "16", "--global-batch", "8"],
    }
    outs = worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, RANKS))
    return {
        "state": state,
        "batches": batches,
        "jax": dict(np.load(work / "jax.npz")),
        "train": [dict(np.load(work / f"train_{r}.npz")) for r in range(RANKS)],
        "one": dict(np.load(work / "one_0.npz")),
        "launch": outs["launch"],
    }


def _params(out, prefix):
    n = len(prefix)
    return {k[n:]: torch.from_numpy(v) for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_manual_hier_matches_jax(runs, schedule):
    """Three manual_hier steps on (2, 2, 2), as the reference's."""
    want, got = runs["jax"], runs["train"][0]
    np.testing.assert_allclose(got[f"{schedule}.loss"], want[f"{schedule}.loss"],
                               atol=JAX_LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[f"{schedule}.grad_norm"], want[f"{schedule}.grad_norm"],
                               rtol=JAX_LOSS_ATOL, atol=0)
    assert got[f"{schedule}.loss"][-1] < got[f"{schedule}.loss"][0]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_ranks_stay_replicated(runs, schedule):
    """Ranks along the DP axes ("pod", "data") hold the same numbers; each
    "model" rank holds its block of the gathered params (TP on "model",
    the reference's automatic axis), the same on every rank."""
    ranks = runs["train"]
    lay = step_layout(get_model(get_smoke_config(ARCH)), _Mesh((2, 2, 2)), "manual_hier")
    split = 0
    for r in range(RANKS):
        model = r % 2  # (2, 2, 2): "model" is the minor axis
        for k, v in ranks[model].items():  # the rank of the same model coordinate
            if k.startswith(schedule + "."):
                np.testing.assert_array_equal(ranks[r][k], v, err_msg=f"{k} rank {r}")
        for k, spec in lay.specs.items():
            whole = ranks[r][f"{schedule}.param.{k}"]
            np.testing.assert_array_equal(whole, ranks[0][f"{schedule}.param.{k}"])
            idx = tuple(slice(model * n // 2, (model + 1) * n // 2) if e == "model"
                        else slice(None) for e, n in zip(spec, whole.shape))
            np.testing.assert_array_equal(ranks[r][f"{schedule}.local.{k}"], whole[idx],
                                          err_msg=f"{k} rank {r}")
            split += r == 0 and "model" in spec
    assert split > 0


class _Mesh:
    """A (pod, data, model) mesh's names and sizes: all a layout's specs
    need."""

    def __init__(self, shape):
        self.mesh_dim_names = ("pod", "data", "model")
        self.shape = shape


@pytest.mark.parametrize("schedule", ["flat", "hierarchical"])
def test_manual_hier_matches_the_one_process_step(runs, schedule):
    """The 8-rank step (4-way DP, 2 x 2 rows a rank) against the port's own
    step on the global batch of 8, at test_torch_train.py's tolerances."""
    ocfg = opt_lib.AdamWConfig(**worlds.OCFG)
    params = ParamTree.from_state_dict({k: v.clone() for k, v in runs["state"].items()},
                                       requires_grad=True)
    step_fn = make_train_step(get_model(get_smoke_config(ARCH)), ocfg, device="cpu")
    opt = opt_lib.init(ocfg, params)
    got = runs["train"][0]
    for i, batch in enumerate(runs["batches"]):
        params, opt, m = step_fn(params, opt, batch)
        np.testing.assert_allclose(got[f"{schedule}.loss"][i], float(m["loss"]), **LOSS)
        np.testing.assert_allclose(got[f"{schedule}.grad_norm"][i], float(m["grad_norm"]),
                                   **LOSS)
    _assert_params_close(_params(got, f"{schedule}.param."), params.state_dict())
    assert got[f"{schedule}.loss"][-1] < got[f"{schedule}.loss"][0]


@pytest.mark.parametrize("schedule", ["flat", "hierarchical"])
def test_world_of_one_is_the_one_process_step_bit_for_bit(runs, schedule):
    one = runs["one"]
    for what in ("loss", "grad_norm"):
        np.testing.assert_array_equal(one[f"{schedule}.{what}"], one[f"none.{what}"])
    want = _params(one, "none.param.")
    got = _params(one, f"{schedule}.param.")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_world_of_one_gspmd_fsdp_is_the_one_process_step(runs):
    """``make_train_step(mesh=)`` with no dp_mode runs gspmd_fsdp; over one
    rank its blocks are the whole leaves and it must give the one-process
    step's losses, grad norms and params."""
    one = runs["one"]
    for what in ("loss", "grad_norm"):
        np.testing.assert_allclose(one[f"gspmd.{what}"], one[f"none.{what}"], rtol=1e-6, atol=0)
    want = _params(one, "none.param.")
    got = _params(one, "gspmd.param.")
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("tag,error,words", [
    ("pod1", "ValueError", ("'pod'", "wrong sum")),
    ("nopod", "ValueError", ("'pod'", "wrong sum")),
    ("ep_axis", None, ()),
    ("sched", "ValueError", ("ring",)),
    ("mode", "ValueError", ("auto",)),
])
def test_make_train_step_refuses(runs, tag, error, words):
    """compressed without a pod axis of size > 1 (the reference's wrong sum)
    and unknown names.  An MoE config whose experts split over "model"
    builds, as the reference's takes any EP axis
    (``test_torch_tp_manual_hier.py`` holds its steps against the
    reference's)."""
    msg = str(runs["one"][f"refuse.{tag}"])
    if error is None:
        assert msg == "", msg
        return
    assert msg.startswith(error + ":"), msg
    for w in words:
        assert w in msg, msg


def test_make_train_step_builds_gspmd_fsdp_for_the_hybrid(runs):
    """Every family has its sharded form: the hybrid's gspmd_fsdp step
    builds where it was refused before (tests/test_torch_fsdp_families.py
    holds its steps against the reference's)."""
    assert str(runs["one"]["refuse.fsdp"]) == ""


def test_launch_train_spawns_a_cpu_world(runs):
    out = runs["launch"]
    assert "mesh: {'pod': 2, 'data': 2, 'model': 2} ranks=8" in out, out
    assert "done: 3 steps" in out and out.count("done:") == 1, out  # rank 0 prints


def test_launch_train_refuses_devices_on_the_card():
    from repro_torch.launch import train as launch_train

    with pytest.raises(SystemExit, match="--device cpu"):
        launch_train.main(["--smoke", "--devices", "2"])
    with pytest.raises(SystemExit, match="torchrun"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "2", "--axes", "data"])


def test_railx_mesh_from_plan_matches_jax():
    cfg = RailXConfig(m=2, n=4, R=32)
    model = ModelSpec(layers=80, hidden=8192, intermediate=28672, vocab=128256, heads=64,
                      kv_heads=8, experts=8, top_k=2)
    shape = WorkloadShape(micro_batch=1, num_micro_batches=8, seq_len=8192)
    for plan in (ParallelismPlan(tp=4, cp=2, ep=2, dp=4, pp=2),
                 ParallelismPlan(tp=4, dp=8), ParallelismPlan(tp=2, cp=1, ep=4, dp=2, pp=1)):
        res = plan_dimension_split(cfg, model, plan, shape)
        assert railx_mesh_from_plan(res) == jax_mesh_from_plan(res)
        assert railx_mesh_from_plan(res)[0]  # a non-empty split
