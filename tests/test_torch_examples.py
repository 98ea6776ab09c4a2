"""The port's twins of the LLM examples against the reference's bodies.

``examples/torch/train_end_to_end.py`` (its ``run`` at a small config, each
attention path, ``gspmd_fsdp`` with 2 microbatches on (2, 2, 2)),
``fault_tolerant_training.py`` (phase 1 on a world of 8 on (4, 2), then
phase 2 on a fresh world of 4 on (2, 2) restoring with resharding),
``quickstart.py`` step 4 (``manual_hier`` + ``hierarchical`` on (2, 2, 2))
(its steps 1-3, on the port's network core, in-process against ``repro.core``)
and ``serve_decode.py`` (qwen3-8b smoke on (4, 2) under a tracer) run in
gloo worlds (``torch_dist_worlds.examples`` / ``examples_shrunk``) from the
JAX inits at ``PRNGKey(0)``; the reference's bodies run in one JAX process
on 8 forced host devices.  The three processes run one after another, each
with a time limit (``torch_dist_worlds.run_in_turn``)."""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402
from test_torch_fsdp import F32, JAX_LOSS_ATOL  # noqa: E402

RANKS, SHRUNK = 8, 4

JAX_SIDE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.configs.base import ModelConfig
from repro.data.pipeline import DataConfig, SyntheticLM, optimal_nll
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import get_model
from repro.obs import Tracer, tracing
from repro.serve.serve_step import BatchScheduler, Request, make_serve_step
from repro.train import optimizer as opt_lib
from repro.train.train_step import make_train_step
from repro.train.trainer import CheckpointPolicy, StragglerMonitor, resume, train_loop

workdir = sys.argv[1]
e2e_cfg, e2e_steps = json.loads(sys.argv[2]), int(sys.argv[3])
drill_steps, drill_every = int(sys.argv[4]), int(sys.argv[5])
out = {}

def placed(arts, data, start):
    s = start
    while True:
        yield {k: jax.device_put(v, arts.batch_sharding[k]) for k, v in data.batch(s).items()}
        s += 1

# examples/train_end_to_end.py's body at a small config, each attention path
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
for impl in ("ref", "flash"):
    cfg = ModelConfig(**e2e_cfg, attn_impl=impl)
    zoo = get_model(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=16)
    data = SyntheticLM(dcfg)
    out["e2e.floor"] = optimal_nll(dcfg)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=e2e_steps, weight_decay=0.01)
    arts = make_train_step(zoo, ocfg, mesh, data.batch(0), dp_mode="gspmd_fsdp", microbatches=2)
    params = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    opt = jax.device_put(opt_lib.init(ocfg, jax.tree_util.tree_map(np.asarray, params)),
                         arts.opt_sharding)
    res = train_loop(arts.step_fn, params, opt, placed(arts, data, 0), num_steps=e2e_steps,
                     ckpt=CheckpointPolicy(f"{workdir}/jax_e2e_{impl}", every_steps=100),
                     straggler=StragglerMonitor(threshold=10.0), log_every=1)
    for key in ("loss", "grad_norm", "step"):
        out[f"e2e.{impl}.{key}"] = [h[key] for h in res.history]

# examples/fault_tolerant_training.py's body, drill_steps a phase
cfg = get_smoke_config("llama3.2-3b")
zoo = get_model(cfg)
data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=60)
ckpt_dir = f"{workdir}/jax_drill"

def run(mesh, params, opt, start, steps):
    arts = make_train_step(zoo, ocfg, mesh, data.batch(0))
    p = jax.device_put(params, arts.param_sharding)
    o = jax.device_put(opt, arts.opt_sharding)
    return train_loop(arts.step_fn, p, o, placed(arts, data, start), num_steps=start + steps,
                      start_step=start, ckpt=CheckpointPolicy(ckpt_dir, every_steps=drill_every),
                      log_every=1)

params = zoo.init(jax.random.PRNGKey(0))
opt = opt_lib.init(ocfg, params)
res1 = run(make_mesh((4, 2), ("data", "model")), params, opt, 0, drill_steps)
mesh2 = make_mesh((2, 2), ("data", "model"))
arts2 = make_train_step(zoo, ocfg, mesh2, data.batch(0))
params_like = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
opt_like = jax.eval_shape(lambda p: opt_lib.init(ocfg, p), params)
p2, o2, start = resume(ckpt_dir, params_like, opt_like,
                       shardings={"params": arts2.param_sharding, "opt": arts2.opt_sharding})
res2 = run(mesh2, p2, o2, start, drill_steps)
out["drill.start"] = start
for tag, res in (("p1", res1), ("p2", res2)):
    out[f"drill.{tag}.loss"] = [h["loss"] for h in res.history]
    out[f"drill.{tag}.step"] = [h["step"] for h in res.history]

# examples/quickstart.py step 4
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
arts = make_train_step(zoo, ocfg, mesh, data.batch(0), dp_mode="manual_hier",
                       schedule="hierarchical")
p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
o = jax.device_put(opt_lib.init(ocfg, zoo.init(jax.random.PRNGKey(0))), arts.opt_sharding)
losses = []
for step in range(5):
    b = {k: jax.device_put(v, arts.batch_sharding[k]) for k, v in data.batch(step).items()}
    p, o, m = arts.step_fn(p, o, b)
    losses.append(float(m["loss"]))
out["quick.loss"] = losses

# examples/serve_decode.py, under the reference's tracer
cfg = get_smoke_config("qwen3-8b")
zoo = get_model(cfg)
mesh = make_mesh((4, 2), ("data", "model"))
SLOTS, CACHE = 4, 64
params = zoo.init(jax.random.PRNGKey(0))
arts = make_serve_step(zoo, mesh, {"tokens": jnp.zeros((SLOTS, 1), jnp.int32)},
                       cache_example=jax.eval_shape(lambda: zoo.init_cache(SLOTS, CACHE)))
params = jax.device_put(params, arts.param_sharding)
cache = jax.device_put(zoo.init_cache(SLOTS, CACHE), arts.cache_sharding)
sched = BatchScheduler(slots=SLOTS, eos_id=1)
rng = np.random.RandomState(0)
for rid in range(6):
    sched.submit(Request(rid=rid, prompt=rng.randint(2, cfg.vocab, 4), max_new=8))
tokens = jnp.zeros((SLOTS, 1), jnp.int32)
steps, sampled_steps, logits_steps = 0, [], []
with tracing(Tracer()) as tracer:
    while not sched.idle and steps < 64:
        for req in sched.admit():
            for t in req.prompt:
                slot = next(s for s, r in sched.active.items() if r is req)
                tokens = tokens.at[slot, 0].set(int(t))
        logits, cache = arts.decode_fn(params, cache, {"tokens": tokens})
        sampled = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        sched.step_tokens(sampled)
        sampled_steps.append(sampled)
        logits_steps.append(np.asarray(logits[:, -1], np.float32))
        tokens = jnp.asarray(sampled[:, None], jnp.int32)
        steps += 1
out["serve.steps"] = steps
out["serve.done"] = 6 - len(sched.queue) - len(sched.active)
out["serve.sampled"] = np.stack(sampled_steps)
out["serve.logits"] = np.stack(logits_steps)
out["serve.spans"] = tracer.phase_totals()["serve.decode_step"]["count"]
np.savez(workdir + "/jax.npz", **out)
"""


def _jax_init(cfg):
    jparams = jax_get_model(cfg).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32",
                           device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process, then the port's world of 8, then its world of 4."""
    import json

    work = tmp_path_factory.mktemp("examples")
    init = {"e2e": _jax_init(JaxModelConfig(**worlds.E2E_CONFIG)),
            "llama": _jax_init(jax_smoke("llama3.2-3b")),
            "qwen": _jax_init(jax_smoke("qwen3-8b"))}
    np.savez(work / "params.npz", **{f"{a}.{k}": v.numpy() for a, st in init.items()
                                     for k, v in st.items()})
    worlds_py = os.path.join(HERE, "torch_dist_worlds.py")
    cmds = {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work),
                json.dumps(worlds.E2E_CONFIG), str(worlds.E2E_STEPS), str(worlds.DRILL_STEPS),
                str(worlds.DRILL_CKPT_EVERY)],
        "examples": [sys.executable, worlds_py, "examples", str(RANKS), str(work)],
        "examples_shrunk": [sys.executable, worlds_py, "examples_shrunk", str(SHRUNK),
                            str(work)],
    }
    worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, RANKS))
    port = [dict(np.load(work / f"examples_{r}.npz")) for r in range(RANKS)]
    shrunk = [dict(np.load(work / f"examples_shrunk_{r}.npz")) for r in range(SHRUNK)]
    return {"jax": dict(np.load(work / "jax.npz")), "port": port, "shrunk": shrunk}


def _same_on_every_rank(outs, keys):
    for out in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k])


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_train_end_to_end_run_matches_the_reference(runs, impl):
    """The end-to-end twin's ``run`` (``gspmd_fsdp``, 2 microbatches, (2, 2,
    2)) against the reference's ``make_train_step`` + ``train_loop`` on the
    same config, mesh and data: per-step losses at the reference's bound,
    grad norms at the same relative bound; the corpus floor is the
    reference's ``optimal_nll``.  ``flash`` runs the kernels' plain versions
    on the CPU and the Pallas kernels in interpret mode in JAX."""
    want, got = runs["jax"], runs["port"][0]
    np.testing.assert_array_equal(got[f"e2e.{impl}.step"], np.arange(worlds.E2E_STEPS))
    np.testing.assert_array_equal(got[f"e2e.{impl}.step"], want[f"e2e.{impl}.step"])
    np.testing.assert_allclose(got[f"e2e.{impl}.loss"], want[f"e2e.{impl}.loss"],
                               atol=JAX_LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[f"e2e.{impl}.grad_norm"], want[f"e2e.{impl}.grad_norm"],
                               rtol=JAX_LOSS_ATOL, atol=0)
    np.testing.assert_allclose(float(got["e2e.floor"]), float(want["e2e.floor"]), rtol=1e-12)
    _same_on_every_rank(runs["port"], [f"e2e.{impl}.loss", f"e2e.{impl}.grad_norm"])


def test_fault_tolerant_drill_matches_the_reference(runs):
    """Phase 1 on (4, 2), then a fresh world of 4 on (2, 2) restoring the
    latest checkpoint with resharding: the restored step and every step's
    loss of both phases equal the reference drill's (one process, 8 host
    devices, ``resume(..., shardings=)``)."""
    want, got = runs["jax"], runs["port"][0]
    shrunk = runs["shrunk"][0]
    n = worlds.DRILL_STEPS
    assert int(shrunk["drill.start"]) == int(want["drill.start"]) == n
    np.testing.assert_array_equal(got["drill.p1.step"], np.arange(n))
    np.testing.assert_array_equal(shrunk["drill.p2.step"], np.arange(n, 2 * n))
    np.testing.assert_allclose(got["drill.p1.loss"], want["drill.p1.loss"],
                               atol=JAX_LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(shrunk["drill.p2.loss"], want["drill.p2.loss"],
                               atol=JAX_LOSS_ATOL, rtol=0)
    _same_on_every_rank(runs["port"], ["drill.p1.loss"])
    _same_on_every_rank(runs["shrunk"], ["drill.start", "drill.p2.loss"])


def test_quickstart_step4_matches_the_reference(runs):
    """Quickstart step 4's five losses (``manual_hier`` + ``hierarchical`` on
    (2, 2, 2)) at the reference's bound."""
    got, want = runs["port"][0]["quick.loss"], runs["jax"]["quick.loss"]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, atol=JAX_LOSS_ATOL, rtol=0)
    assert got[-1] < got[0]
    _same_on_every_rank(runs["port"], ["quick.loss"])


def test_serve_decode_matches_the_reference(runs):
    """serve_decode on (4, 2): the tokens sampled at every step, the decode
    steps, the completed requests and the ``serve.decode_step`` span count
    equal the reference's run under ``repro.obs.tracing``; each step's last
    logits agree at the F32 bound of ``test_torch_fsdp``.  Every rank's
    trace validates and counts one span a decode call."""
    want, got = runs["jax"], runs["port"][0]
    assert int(got["serve.steps"]) == int(want["serve.steps"]) > 0
    assert int(got["serve.done"]) == int(want["serve.done"]) >= 4
    np.testing.assert_array_equal(got["serve.sampled"], want["serve.sampled"])
    np.testing.assert_allclose(got["serve.logits"], want["serve.logits"], **F32)
    assert int(got["serve.spans"]) == int(want["serve.spans"]) == int(want["serve.steps"])
    for out in runs["port"]:
        assert int(out["serve.spans"]) == int(out["serve.valid_spans"]) == int(out["serve.steps"])
    _same_on_every_rank(runs["port"], ["serve.sampled", "serve.logits"])


def _twin(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(HERE, "..", "examples", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_steps_1_to_3_match_the_reference():
    """Quickstart steps 1-3 on ``repro_torch.core`` print the reference
    example's lines, made here from the values the same ``repro.core``
    calls return."""
    from repro.core.analytical import t_allreduce_2d_ring, t_allreduce_hierarchical
    from repro.core.cost import table3
    from repro.core.mapping import ModelSpec, ParallelismPlan, WorkloadShape, plan_dimension_split
    from repro.core.topology import RailXConfig, table2_metrics

    lines = []
    got = _twin("quickstart").steps_1_to_3(lines.append)
    cfg = RailXConfig(m=4, n=9, R=128)
    want = [f"RailX m=4 n=9 R=128: {cfg.num_chips} chips, {cfg.num_switches} OCSes"]
    for name, row in table2_metrics(cfg).items():
        want.append(f"  {name:10s} scale={row['scale']:>10.0f} diam={row['diameter_ho']:>3} "
                    f"bisect/chip={row['bisection_per_chip']:.2f}")
    rx = [r for r in table3() if r["name"] == "RailX7Mesh"][0]
    want.append(f"  cost: {rx['cost_musd']}M$ for {rx['scale']} chips "
                f"({rx['cost_per_inject_x']}x FT cost/injection)")
    res = plan_dimension_split(
        cfg, ModelSpec(layers=80, hidden=8192, intermediate=28672, vocab=128256, heads=64,
                       kv_heads=8, experts=8, top_k=2),
        ParallelismPlan(tp=16, cp=2, ep=8, dp=16, pp=4),
        WorkloadShape(micro_batch=1, num_micro_batches=8, seq_len=8192))
    want.append("\ndimension split (rails per logical dim):")
    want += [f"  {s.name:4s} phys={s.phys} scale={s.scale:<4d} rails={s.rails:<3d} "
             f"{s.interconnect}" for s in res.specs]
    V, nB, alpha = 2 * 8192 * 28672 * 3 / 16, 9 * 100e9, 300e-9
    ring = t_allreduce_2d_ring(4, 16, V, nB, alpha)
    hier = t_allreduce_hierarchical(4, 16, V, nB, alpha, 4.0)
    want.append(f"\nDP grad all-reduce estimate: 2D-ring {ring*1e3:.2f} ms vs "
                f"hierarchical {hier*1e3:.2f} ms ({ring/hier:.2f}x)")
    assert lines == want
    assert (got["ring"], got["hier"]) == (ring, hier)
    assert [(s.name, s.phys, s.scale, s.rails, s.interconnect) for s in got["split"].specs] == \
        [(s.name, s.phys, s.scale, s.rails, s.interconnect) for s in res.specs]


def test_mlaas_allocation_prints_the_reference_examples_lines():
    """``examples/torch/mlaas_allocation.py --device cpu`` (both acts, the
    port's cluster twin) prints the lines of ``examples/mlaas_allocation.py``
    run here in-process on the reference."""
    import contextlib
    import importlib.util
    import io
    import subprocess

    spec = importlib.util.spec_from_file_location(
        "ref_mlaas_allocation", os.path.join(HERE, "..", "examples", "mlaas_allocation.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        ref.main()
        ref.policy_demo()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    got = subprocess.run(
        [sys.executable, os.path.join(HERE, "..", "examples", "torch", "mlaas_allocation.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout == want.getvalue()


TWINS = sorted(f for f in os.listdir(os.path.join(HERE, "..", "examples", "torch"))
               if f.endswith(".py"))


@pytest.mark.parametrize("path", [f"examples/torch/{f}" for f in TWINS] + ["chip_profile.py"])
def test_twins_import_no_jax_and_no_reference_package(path):
    """The twins (and the card profiler, which drives the drill) import
    ``torch`` and the port, never ``jax`` or anything of ``repro``."""
    import ast

    with open(os.path.join(HERE, "..", path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert any(n.startswith("repro_torch") for n in names) or path == "chip_profile.py"
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name
