"""Rank bodies of the port's gloo worlds for ``tests/test_torch_collectives.py``,
``tests/test_torch_dist_train.py``, ``tests/test_torch_fsdp.py``,
``tests/test_torch_moe_ep.py``, ``tests/test_torch_fsdp_families.py``,
``tests/test_torch_pipeline.py``, ``tests/test_torch_tp_manual_hier.py``,
``tests/test_torch_seq_parallel.py`` and ``tests/test_torch_examples.py``; imports
neither JAX nor ``repro``.

    python tests/torch_dist_worlds.py NAME WORLD WORKDIR

spawns WORLD local gloo ranks running ``NAME(rank, world, workdir)``; each
reads its inputs from ``WORKDIR/inputs.npz`` and writes
``WORKDIR/NAME_{rank}.npz``.  A rank's local input is block ``rank`` of
each input, and rank r sits at mesh coordinate ``unravel(r, shape)``, as
device r of a JAX mesh whose local blocks are ``P(all axes)``.

``run_in_turn`` is how the test modules start these worlds and their JAX
processes: one process at a time, under one file lock that every test
process of a pytest run shares, with the JAX side single-threaded, so that
at most one world loads the host's cores at any moment.
"""

import contextlib
import fcntl
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.collectives import compression as C  # noqa: E402
from repro_torch.collectives import schedules as S  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world  # noqa: E402

TRAIN_STEPS = 3
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)
# a world's or a JAX process's time limit
TIMEOUT = 180
# the CPU priority of the worlds and their JAX processes, below the test
# processes': with 8 ranks on the host's cores, a test with a deadline
# (Hypothesis's 200 ms) in another process must not wait for a core
NICE = 10


def jax_env(src: str, devices: int) -> dict:
    """The environment of a JAX process on ``devices`` forced host devices,
    single-threaded."""
    return dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices} "
                          "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")


@contextlib.contextmanager
def one_world_at_a_time(tmp_path_factory):
    """A file lock in the parent of pytest's base temp dir, which the xdist
    workers of a run share."""
    path = tmp_path_factory.getbasetemp().parent / "torch_dist_worlds.lock"
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_in_turn(tmp_path_factory, cmds: dict, env: dict) -> dict:
    """Run each command of ``{name: argv}`` to its end, one after another,
    under ``one_world_at_a_time``; each must exit 0 within ``TIMEOUT``.
    Each runs at ``NICE``: a world's ranks fill the host's cores, and the
    test processes beside it keep theirs.  Returns ``{name: stdout}``."""
    outs = {}
    nice = shutil.which("nice")
    with one_world_at_a_time(tmp_path_factory):
        for name, cmd in cmds.items():
            if nice:
                cmd = [nice, "-n", str(NICE), *cmd]
            proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT)
            assert proc.returncode == 0, (name, proc.stderr[-4000:])
            outs[name] = proc.stdout
    return outs


def _save(workdir, name, rank, out):
    np.savez(os.path.join(workdir, f"{name}_{rank}.npz"),
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in out.items()})


def collective_cases(x, tree):
    """name -> fn(mesh) on the (4, 2) ("node", "mesh") mesh."""
    return {
        "flat": lambda m: S.flat_all_reduce(x, m, ("node", "mesh")),
        "hierarchical": lambda m: S.hierarchical_all_reduce(x, m, "mesh", "node"),
        "ring2d": lambda m: S.ring_all_reduce_2d(x, m, ("mesh", "node")),
        "ring2d_yx": lambda m: S.ring_all_reduce_2d(x, m, ("node", "mesh")),
        "rs_dim0": lambda m: S.reduce_scatter_axis(x, m, ("node", "mesh"), 0),
        "rs_dim1": lambda m: S.reduce_scatter_axis(x, m, ("mesh", "node"), 1),
        "ag_dim0": lambda m: S.all_gather_axis(x, m, ("node", "mesh"), 0),
        "ag_dim1": lambda m: S.all_gather_axis(x, m, "mesh", 1),
        "hier_rs": lambda m: S.hierarchical_reduce_scatter(x, m, "mesh", "node", 0),
        "hier_rs_ag": lambda m: S.hierarchical_all_gather(
            S.hierarchical_reduce_scatter(x, m, "mesh", "node", 0), m, "mesh", "node", 0),
        "a2a_node": lambda m: S.all_to_all_axis(x, m, "node", 0, 1),
        "a2a_mesh": lambda m: S.all_to_all_axis(x, m, "mesh", 1, 0),
        "tree_hier": lambda m: S.tree_hierarchical_all_reduce(tree, m, "mesh", "node"),
        "tree_flat": lambda m: S.tree_flat_all_reduce(tree, m, ("node", "mesh")),
    }


def collectives(rank, world, workdir):
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    x = torch.from_numpy(inp["x"][rank])
    tree = {"a": x[:5, :7], "b": x[0, :3]}
    out = {}
    mesh = make_mesh((4, 2), ("node", "mesh"), "cpu")
    for name, fn in collective_cases(x, tree).items():
        got = fn(mesh)
        if isinstance(got, dict):
            out.update({f"{name}.{k}": v for k, v in got.items()})
        else:
            out[name] = got
    assert torch.equal(x, torch.from_numpy(inp["x"][rank]))  # inputs left as they were

    # the Eq. 8 byte ledger on (2, 4)
    mesh = make_mesh((2, 4), ("node", "mesh"), "cpu")
    v = torch.from_numpy(inp["v"][rank])
    for sched in ("flat", "hierarchical"):
        with S.byte_ledger() as ledger:
            S.make_all_reduce_fn(mesh, sched, "mesh", "node")(v)
        for op in ("all_reduce", "reduce_scatter", "all_gather"):
            out[f"bytes.{sched}.{op}.node"] = ledger.bytes(op, spanning="node")
            out[f"bytes.{sched}.{op}.mesh"] = ledger.bytes(op, spanning="mesh")

    # int8 compression over (pod, data); ranks along model hold the same input
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    y = torch.from_numpy(inp["y"][rank // 2])
    out["compressed"] = C.compressed_hierarchical_all_reduce(y, mesh, "data", "pod")
    try:
        C.compressed_hierarchical_all_reduce(y, mesh, "data", "data")
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    _save(workdir, "collectives", rank, out)


def _zoo():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model

    return get_model(get_smoke_config("llama3.2-3b"))


def _params(workdir):
    from repro_torch.models.common import ParamTree

    state = np.load(os.path.join(workdir, "params.npz"))
    return ParamTree.from_state_dict({k: torch.from_numpy(state[k].copy()) for k in state.files},
                                     requires_grad=True)


def _run(step_fn, params, batches, steps, opt_lib, ocfg):
    opt = opt_lib.init(ocfg, params)
    losses, gnorms = [], []
    for i in range(steps):
        params, opt, m = step_fn(params, opt, batches[i])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return params, losses, gnorms


def train(rank, world, workdir):
    """Three manual_hier steps of the smoke model on (2, 2, 2) for each
    schedule, from the weights in params.npz: losses, grad norms, each
    rank's blocks and the gathered params."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]}
               for i in range(TRAIN_STEPS)]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    ocfg = opt_lib.AdamWConfig(**OCFG)
    out = {}
    for sched in ("flat", "hierarchical", "compressed"):
        step_fn = make_train_step(_zoo(), ocfg, device="cpu", mesh=mesh, dp_mode="manual_hier",
                                  schedule=sched)
        params, losses, gnorms = _run(step_fn, step_fn.layout.shard(_params(workdir)), batches,
                                      TRAIN_STEPS, opt_lib, ocfg)
        out[f"{sched}.loss"] = losses
        out[f"{sched}.grad_norm"] = gnorms
        out.update({f"{sched}.local.{k}": v for k, v in params.state_dict().items()})
        out.update({f"{sched}.param.{k}": v
                    for k, v in step_fn.layout.gather(params).state_dict().items()})
    _save(workdir, "train", rank, out)


def one(rank, world, workdir):
    """A world of one: the mesh steps (``manual_hier`` per schedule, and
    ``gspmd_fsdp``, the default) must be the one-process step; the
    refusals, and the hybrid's gspmd_fsdp step, which builds."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]} for i in range(2)]
    ocfg = opt_lib.AdamWConfig(**OCFG)
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    out = {}
    runs = {"none": make_train_step(_zoo(), ocfg, device="cpu"),
            "gspmd": make_train_step(_zoo(), ocfg, device="cpu", mesh=mesh)}
    for sched in ("flat", "hierarchical"):
        runs[sched] = make_train_step(_zoo(), ocfg, device="cpu", mesh=mesh,
                                      dp_mode="manual_hier", schedule=sched)
    for name, step_fn in runs.items():
        params, losses, gnorms = _run(step_fn, _params(workdir), batches, 2, opt_lib, ocfg)
        out[f"{name}.loss"] = losses
        out[f"{name}.grad_norm"] = gnorms
        out.update({f"{name}.param.{k}": v for k, v in params.state_dict().items()})

    data_only = make_mesh((1,), ("data",), "cpu")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model

    import dataclasses

    hybrid = get_model(get_smoke_config("zamba2-7b"))
    ep_model = get_model(dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"),
                                             moe_ep_axis="model"))
    manual = dict(dp_mode="manual_hier")
    for tag, zoo, m, kw in (("pod1", _zoo(), mesh, dict(manual, schedule="compressed")),
                            ("nopod", _zoo(), data_only, dict(manual, schedule="compressed")),
                            ("fsdp", hybrid, mesh, dict(dp_mode="gspmd_fsdp")),
                            ("ep_axis", ep_model, mesh, dict(dp_mode="gspmd_fsdp")),
                            ("sched", _zoo(), mesh, dict(manual, schedule="ring")),
                            ("mode", _zoo(), mesh, dict(dp_mode="auto"))):
        try:
            make_train_step(zoo, ocfg, device="cpu", mesh=m, **kw)
            out[f"refuse.{tag}"] = ""
        except (ValueError, NotImplementedError) as e:
            out[f"refuse.{tag}"] = f"{type(e).__name__}: {e}"
    _save(workdir, "one", rank, out)


FSDP_ARCHS = ("llama3.2-3b", "qwen3-8b", "granite-20b")
SERVE_ARCHS = ("qwen3-8b", "granite-20b")
SERVE_SLOTS, SERVE_CACHE = 4, 16
# the sharded step's other "model" layouts: (smoke arch, fields replaced, mesh)
ODD_CASES = {
    # 4 heads over a model axis of 8: attention runs whole on every rank from
    # weights gathered over "model"; the MLP and the vocab stay split
    "whole_heads": ("llama3.2-3b", {}, (1, 1, 8)),
    # 3 query heads a rank over KV groups of 4: each rank picks its KV heads
    "kv_select": ("llama3.2-3b", dict(d_model=96, heads=12, kv_heads=3), (1, 2, 4)),
}


def odd_config(name):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    arch, fields, _ = ODD_CASES[name]
    return dataclasses.replace(get_smoke_config(arch), **fields)


def _whole_params(workdir, arch):
    init = np.load(os.path.join(workdir, "params.npz"))
    n = len(arch) + 1
    return {k[n:]: torch.from_numpy(init[k].copy()) for k in init.files if k.startswith(arch + ".")}


def fsdp(rank, world, workdir):
    """gspmd_fsdp (the default dp_mode) on (2, 2, 2) for the dense smoke
    configs from the JAX init in params.npz, 3 steps each: losses, grad
    norms, each rank's blocks and the gathered params and moments; for
    llama also 3 steps with 2 microbatches and of manual_hier, a sharded
    checkpoint, one step under the byte ledger and a masked loss.  Then the
    sharded serving steps on (4, 2) ("data", "model")."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.collectives import byte_ledger
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import (
        batch_specs_tree, block_slices, param_layout, placements,
    )
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]}
               for i in range(TRAIN_STEPS)]
    ocfg = opt_lib.AdamWConfig(**OCFG)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    out = {}
    for arch in FSDP_ARCHS:
        zoo = get_model(get_smoke_config(arch))
        whole = _whole_params(workdir, arch)
        lay = param_layout(zoo, mesh)
        runs = [("gspmd", {}, 1)]
        if arch == "llama3.2-3b":
            runs += [("mb2", {}, 2), ("manual", {"dp_mode": "manual_hier"}, 1)]
        for tag, kw, micro in runs:
            params = ParamTree.from_state_dict({k: v.clone() for k, v in whole.items()},
                                               requires_grad=True)
            step_fn = make_train_step(zoo, ocfg, micro, device="cpu", mesh=mesh, **kw)
            params = step_fn.layout.shard(params)
            opt = opt_lib.init(ocfg, params)
            losses, gnorms = [], []
            for b in batches:
                params, opt, m = step_fn(params, opt, b)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            out[f"{arch}.{tag}.loss"], out[f"{arch}.{tag}.grad_norm"] = losses, gnorms
            if tag != "gspmd":
                continue
            local = params.state_dict()
            gathered = lay.gather(params).state_dict()
            mu = lay.gather(opt.mu)
            ok = True
            for k, v in local.items():  # copies: the ledger step below updates in place
                out[f"{arch}.local.{k}"] = v.clone()
                out[f"{arch}.local_mu.{k}"] = opt.mu[k].clone()
                out[f"{arch}.param.{k}"] = gathered[k]
                out[f"{arch}.mu.{k}"] = mu[k]
                dt = distribute_tensor(gathered[k], mesh, placements(lay.specs[k], mesh))
                ok = ok and torch.equal(dt.to_local(), v)
            out[f"{arch}.dtensor_blocks"] = ok
            if arch != "llama3.2-3b":
                continue
            ckpt_lib.save(os.path.join(workdir, "ckpt"), TRAIN_STEPS,
                          {"params": params, "opt": opt}, extra={"step": TRAIN_STEPS},
                          layout=lay)
            with byte_ledger() as ledger:
                step_fn(params, opt, batches[0])
            out["ledger.op"] = [r.op for r in ledger.records]
            out["ledger.axes"] = [",".join(r.axes) for r in ledger.records]
            out["ledger.bytes"] = [r.nbytes for r in ledger.records]
        if arch == "llama3.2-3b":
            # the global masked mean, every rank from its rows
            b = dict(batches[0], loss_mask=inp["mask"])
            b = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            specs, coord = batch_specs_tree(mesh, b), lay.coord
            mine = {k: v[block_slices(v.shape, specs[k], lay.sizes, coord)] for k, v in b.items()}
            plan = zoo.shard_plan(lay)
            with torch.no_grad():
                loss, _ = zoo.loss(lay.shard(ParamTree.from_state_dict(whole)), mine, plan)
            out["masked_loss"] = float(loss)

    for name, (_, _, shape) in ODD_CASES.items():
        zoo = get_model(odd_config(name))
        lay = param_layout(zoo, make_mesh(shape, ("pod", "data", "model"), "cpu"))
        params = lay.shard(zoo.init(0, device="cpu"))
        step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=lay.mesh)
        opt = opt_lib.init(ocfg, params)
        losses, gnorms = [], []
        for b in batches:
            params, opt, m = step_fn(params, opt, b)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[f"odd.{name}.loss"], out[f"odd.{name}.grad_norm"] = losses, gnorms
        out.update({f"odd.{name}.param.{k}": v
                    for k, v in lay.gather(params).state_dict().items()})

    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    prompt = torch.from_numpy(inp["prompt"])
    for arch in SERVE_ARCHS:
        zoo = get_model(get_smoke_config(arch))
        arts = make_serve_step(zoo, "cpu", mesh=mesh,
                               batch_example={"tokens": np.zeros((SERVE_SLOTS, 1), np.int64)},
                               cache_example=zoo.init_cache(SERVE_SLOTS, SERVE_CACHE,
                                                            device="cpu"))
        params = arts.param_layout.shard(ParamTree.from_state_dict(_whole_params(workdir, arch)))
        cache = arts.cache_layout.shard(zoo.init_cache(SERVE_SLOTS, SERVE_CACHE, device="cpu"))
        out[f"serve.{arch}.cache_shape"] = list(cache["k"].shape)
        out[f"serve.{arch}.prefill"] = arts.prefill_fn(params, {"tokens": prompt})
        for i in range(prompt.shape[1]):
            logits, cache = arts.decode_fn(params, cache, {"tokens": prompt[:, i:i + 1]})
            out[f"serve.{arch}.decode{i}"] = logits
        out[f"serve.{arch}.index"] = cache["index"]
    _save(workdir, "fsdp", rank, out)


# the hybrid, xLSTM, whisper and vlm smoke configs: gspmd_fsdp on (2, 2, 2)
# and (but the vlm) sharded serving on (4, 2)
FAMILY_ARCHS = ("zamba2-7b", "xlstm-125m", "whisper-large-v3", "qwen2-vl-2b")
FAMILY_SERVE = ("zamba2-7b", "xlstm-125m", "whisper-large-v3")


def family_batch(inp, arch, i):
    """Step ``i``'s batch of ``arch`` from inputs.npz (keys ``arch/i/name``)."""
    pre = f"{arch}/{i}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def _grads_from_jax(zoo, mesh, inp, arch, workdir, out):
    """From each of the reference's params before its steps (``jax.npz``
    keys ``arch.before{i}.*``, where it recorded them), the gathered
    gradient of the sharded loss on step i's batch."""
    from repro_torch.models.common import ParamTree
    from repro_torch.train.train_step import _GspmdFsdp, to_device

    ref = np.load(os.path.join(workdir, "jax.npz"))
    fsdp = _GspmdFsdp(zoo, mesh)
    for i in range(TRAIN_STEPS):
        pre = f"{arch}.before{i}."
        whole = {k[len(pre):]: torch.from_numpy(ref[k].copy()) for k in ref.files
                 if k.startswith(pre)}
        if not whole:
            return
        params = fsdp.layout.shard(ParamTree.from_state_dict(whole, requires_grad=True))
        mb = fsdp.microbatches(to_device(family_batch(inp, arch, i), torch.device("cpu")), 1)[0]
        zoo.loss(params, mb, fsdp.plan)[0].backward()
        grads = fsdp.reduce_grads({k: p.grad for k, p in params.named_parameters()})
        out.update({f"{arch}.grad{i}.{k}": v for k, v in fsdp.layout.gather(grads).items()})


def families(rank, world, workdir):
    """gspmd_fsdp on (2, 2, 2) for ``FAMILY_ARCHS`` from the JAX inits in
    params.npz, 3 steps each: losses, grad norms, each rank's param and
    moment blocks and the gathered params; then ``make_serve_step(mesh=)``
    on (4, 2) for ``FAMILY_SERVE``: prefill, the prompt decoded one token a
    call, and each rank's cache blocks after it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import flatten, param_layout
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    ocfg = opt_lib.AdamWConfig(**OCFG)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    out = {}
    for arch in FAMILY_ARCHS:
        zoo = get_model(get_smoke_config(arch))
        lay = param_layout(zoo, mesh)
        params = lay.shard(ParamTree.from_state_dict(_whole_params(workdir, arch),
                                                     requires_grad=True))
        step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=mesh)
        opt = opt_lib.init(ocfg, params)
        losses, gnorms = [], []
        for i in range(TRAIN_STEPS):
            params, opt, m = step_fn(params, opt, family_batch(inp, arch, i))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[f"{arch}.loss"], out[f"{arch}.grad_norm"] = losses, gnorms
        if os.path.exists(os.path.join(workdir, "jax.npz")):
            _grads_from_jax(zoo, mesh, inp, arch, workdir, out)
        gathered = lay.gather(params).state_dict()
        for k, v in params.state_dict().items():
            out[f"{arch}.local.{k}"] = v
            out[f"{arch}.local_mu.{k}"] = opt.mu[k]
            out[f"{arch}.param.{k}"] = gathered[k]

    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    for arch in FAMILY_SERVE:
        zoo = get_model(get_smoke_config(arch))
        prompt = torch.from_numpy(inp[f"{arch}/prompt"])
        whole_cache = zoo.init_cache(SERVE_SLOTS, SERVE_CACHE, device="cpu")
        arts = make_serve_step(zoo, "cpu", mesh=mesh,
                               batch_example={"tokens": np.zeros((SERVE_SLOTS, 1), np.int64)},
                               cache_example=whole_cache)
        params = arts.param_layout.shard(ParamTree.from_state_dict(_whole_params(workdir, arch)))
        cache = arts.cache_layout.shard(whole_cache)
        batch = {"tokens": prompt}
        if zoo.has_encoder:
            enc = torch.from_numpy(inp[f"{arch}/enc_embeds"])
            batch["enc_embeds"] = enc
            cache["enc_out"] = arts.encode_fn(params, enc)
        out[f"serve.{arch}.prefill"] = arts.prefill_fn(params, batch)
        for i in range(prompt.shape[1]):
            logits, cache = arts.decode_fn(params, cache, {"tokens": prompt[:, i:i + 1]})
            out[f"serve.{arch}.decode{i}"] = logits
        for k, v in flatten(cache).items():
            out[f"serve.{arch}.cache.{k}"] = v
    _save(workdir, "families", rank, out)


def pipeline(rank, world, workdir):
    """``make_pipelined_apply`` on a (4,) "pipe" ring, the reference's test:
    4 stages, each multiplying by its stage weight, over 6 microbatches; and
    on (4, 1) ("rep", "pipe"), a one-stage ring on each rank."""
    from repro_torch.parallel.pipeline import make_pipelined_apply

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    ws, xs = torch.from_numpy(inp["ws"]), torch.from_numpy(inp["xs"])

    def stage(w, x):
        return x @ w

    out = {"four": make_pipelined_apply(make_mesh((4,), ("pipe",), "cpu"), stage, 6)(ws, xs),
           "one": make_pipelined_apply(make_mesh((4, 1), ("rep", "pipe"), "cpu"), stage,
                                       6)(ws[rank:rank + 1], xs)}
    _save(workdir, "pipeline", rank, out)


# moe_ffn_ep cases: (mesh shape, axes, token_scatter, capacity factor).  A
# leading "rep" axis of 2 fills the world of 8: its two halves compute the
# same thing, and the EP and TP axes are the JAX mesh's
MOE_EP_CASES = {
    "data4": ((2, 4), ("rep", "data"), False, 1.25),
    "dm22": ((2, 2, 2), ("rep", "data", "model"), False, 1.25),
    "dm22_scatter": ((2, 2, 2), ("rep", "data", "model"), True, 1.25),
    "data4_loose": ((2, 4), ("rep", "data"), False, 8.0),
}
MOE_ARCH = "moonshot-v1-16b-a3b"


def moe_layer_config(token_scatter=False, capacity_factor=1.25):
    from repro_torch.models.moe import MoEConfig

    return MoEConfig(d_model=32, d_ff=16, num_experts=8, top_k=2,
                     capacity_factor=capacity_factor, token_scatter=token_scatter)


def _moe_ep_cases(rank, inp, out):
    """moe_ffn_ep on each case's mesh from the whole layer in inputs.npz:
    the rank's rows and blocks in, its output, aux (averaged over "data"
    by ``aux_mean``) and gradients out
    (loss sum(out * ct) + aux), the router's summed over the batch axes;
    each case's byte ledger."""
    from repro_torch.collectives import byte_ledger
    from repro_torch.models.common import DTypes, TP
    from repro_torch.models.moe import EPGroup, aux_mean, moe_ffn_ep

    for name, (shape, axes, scatter, cf) in MOE_EP_CASES.items():
        mesh = make_mesh(shape, axes, "cpu")
        coord = dict(zip(axes, mesh.get_coordinate()))
        n_data, d = shape[axes.index("data")], coord["data"]
        tp = TP(mesh) if "model" in axes else None
        m = coord.get("model", 0)
        n_tp = tp.size if tp is not None else 1
        rows = inp["moe.x"].shape[0] // n_data
        E, F = inp["moe.wi"].shape[0], inp["moe.wi"].shape[2]
        e0, f0 = d * E // n_data, m * F // n_tp
        es, fs = slice(e0, e0 + E // n_data), slice(f0, f0 + F // n_tp)

        def leaf(a):
            return torch.from_numpy(a.copy()).requires_grad_(True)

        p = {"router": {"w": leaf(inp["moe.router"])}, "wi": leaf(inp["moe.wi"][es, :, fs]),
             "wg": leaf(inp["moe.wg"][es, :, fs]), "wo": leaf(inp["moe.wo"][es, fs, :])}
        x = leaf(inp["moe.x"][d * rows:(d + 1) * rows])
        ct = torch.from_numpy(inp["moe.ct"][d * rows:(d + 1) * rows])
        ep = EPGroup(mesh, ("data",), tp)
        with byte_ledger() as ledger:
            y, aux = moe_ffn_ep(p, moe_layer_config(scatter, cf), x, DTypes(), ep)
            aux = aux_mean(aux, ep)  # the reference's pmean inside its moe_ffn_ep
            (torch.sum(y * ct) + aux).backward()
        out[f"{name}.y"], out[f"{name}.aux"] = y, aux
        out[f"{name}.g.x"] = x.grad
        out[f"{name}.g.router"] = S.all_reduce_axis(p["router"]["w"].grad, mesh, "data")
        for k in ("wi", "wg", "wo"):
            out[f"{name}.g.{k}"] = p[k].grad
        out[f"{name}.ledger.op"] = [r.op for r in ledger.records]
        out[f"{name}.ledger.axes"] = [",".join(r.axes) for r in ledger.records]
        out[f"{name}.ledger.bytes"] = [r.nbytes for r in ledger.records]


def moe_ep(rank, world, workdir):
    """The MoE family's sharded forms: ``moe_ffn_ep`` on each of
    ``MOE_EP_CASES``; ``gspmd_fsdp`` (EP over "data", TP over "model") for
    moonshot-smoke on (2, 2, 2) from the JAX init in params.npz, 3 steps,
    then one under the byte ledger; the ``manual_hier`` refusal; the
    sharded serving steps on (4, 2) ("data", "model")."""
    from repro_torch.collectives import byte_ledger
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    _moe_ep_cases(rank, inp, out)

    zoo = get_model(get_smoke_config(MOE_ARCH))
    whole = _whole_params(workdir, MOE_ARCH)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    lay = param_layout(zoo, mesh)
    ocfg = opt_lib.AdamWConfig(**OCFG)
    params = lay.shard(ParamTree.from_state_dict({k: v.clone() for k, v in whole.items()},
                                                 requires_grad=True))
    step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=mesh)
    opt = opt_lib.init(ocfg, params)
    batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]}
               for i in range(TRAIN_STEPS)]
    hist = {"loss": [], "aux": [], "grad_norm": []}
    for b in batches:
        params, opt, m = step_fn(params, opt, b)
        for k in hist:
            hist[k].append(float(m[k]))
    out.update({f"fsdp.{k}": v for k, v in hist.items()})
    for k, v in params.state_dict().items():
        out[f"fsdp.local.{k}"] = v.clone()
    out.update({f"fsdp.param.{k}": v for k, v in lay.gather(params).state_dict().items()})
    with byte_ledger() as ledger:
        step_fn(params, opt, batches[0])
    out["fsdp.ledger.op"] = [r.op for r in ledger.records]
    out["fsdp.ledger.axes"] = [",".join(r.axes) for r in ledger.records]
    out["fsdp.ledger.bytes"] = [r.nbytes for r in ledger.records]
    try:
        make_train_step(zoo, ocfg, device="cpu", mesh=mesh, dp_mode="manual_hier")
        out["refuse.manual_hier"] = ""
    except ValueError as e:
        out["refuse.manual_hier"] = str(e)

    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    prompt = torch.from_numpy(inp["prompt"])
    arts = make_serve_step(zoo, "cpu", mesh=mesh,
                           batch_example={"tokens": np.zeros((SERVE_SLOTS, 1), np.int64)},
                           cache_example=zoo.init_cache(SERVE_SLOTS, SERVE_CACHE, device="cpu"))
    params = arts.param_layout.shard(ParamTree.from_state_dict(whole))
    cache = arts.cache_layout.shard(zoo.init_cache(SERVE_SLOTS, SERVE_CACHE, device="cpu"))
    out["serve.local.wi"] = params["layers"]["moe"]["wi"]
    out["serve.prefill"] = arts.prefill_fn(params, {"tokens": prompt})
    for i in range(prompt.shape[1]):
        logits, cache = arts.decode_fn(params, cache, {"tokens": prompt[:, i:i + 1]})
        out[f"serve.decode{i}"] = logits
    _save(workdir, "moe_ep", rank, out)


# tensor parallelism inside manual_hier: every non-MoE family on both meshes
TP_ARCHS = ("llama3.2-3b", "gemma3-4b", "qwen2-vl-2b", "whisper-large-v3", "zamba2-7b",
            "xlstm-125m")
TP_MESHES = ((2, 2, 2), (1, 2, 4))
TP_STEPS = 2
# gspmd_fsdp steps under the dry run's attention_overrides: (smoke arch, mesh)
OV_CASES = {"kv_whole": ("llama3.2-3b", (1, 2, 4)), "heads_whole": ("llama3.2-3b", (1, 1, 8))}
# the MoE layers on other axes: (mesh shape, axes, fields of the smoke config)
MOE_AXES_CASES = {
    "ep_model": ((2, 2, 2), ("pod", "data", "model"), {"moe_ep_axis": "model"}),
    "pod_model": ((2, 4), ("pod", "model"), {}),
    "model": ((8,), ("model",), {}),
}
# decode over a cache cut by position: (smoke arch, |data|); a leading "rep"
# axis fills the world of 8
KV_CASES = {"llama_d2": ("llama3.2-3b", 2), "llama_d4": ("llama3.2-3b", 4),
            "zamba2_d2": ("zamba2-7b", 2), "zamba2_d4": ("zamba2-7b", 4)}
KV_OVERRIDES = {"batch": None, "kv_seq": "data"}
KV_CACHE = 16


def tp_batch(inp, arch, i):
    """Step ``i``'s batch of ``arch`` from inputs.npz (keys ``tp/arch/i/name``)."""
    pre = f"tp/{arch}/{i}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def _steps(step_fn, params, opt_lib, ocfg, batches):
    opt = opt_lib.init(ocfg, params)
    losses, gnorms, aux = [], [], []
    for b in batches:
        params, opt, m = step_fn(params, opt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        aux.append(float(m["aux"]))
    return params, opt, {"loss": losses, "grad_norm": gnorms, "aux": aux}


def tp(rank, world, workdir):
    """``manual_hier`` (hierarchical) with TP on "model" for ``TP_ARCHS`` on
    both ``TP_MESHES`` from the JAX inits in params.npz, ``TP_STEPS`` steps:
    losses, grad norms, each rank's blocks and the gathered params; a
    checkpoint round trip of the llama run; ``gspmd_fsdp`` under
    ``OV_CASES``' attention_overrides (layout specs too); the MoE layers on
    ``MOE_AXES_CASES``; decode over a cache cut by position on
    ``KV_CASES``."""
    import dataclasses

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import attention_overrides, flatten
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    ocfg = opt_lib.AdamWConfig(**OCFG)
    out = {}

    def tree(arch):
        return ParamTree.from_state_dict({k: v.clone() for k, v in
                                          _whole_params(workdir, arch).items()},
                                         requires_grad=True)

    for arch in TP_ARCHS:
        zoo = get_model(get_smoke_config(arch))
        batches = [tp_batch(inp, arch, i) for i in range(TP_STEPS)]
        for shape in TP_MESHES:
            tag = f"tp.{arch}.{''.join(map(str, shape))}"
            mesh = make_mesh(shape, ("pod", "data", "model"), "cpu")
            step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=mesh, dp_mode="manual_hier")
            lay = step_fn.layout
            params, opt, hist = _steps(step_fn, lay.shard(tree(arch)), opt_lib, ocfg, batches)
            out.update({f"{tag}.{k}": v for k, v in hist.items()})
            for k, v in params.state_dict().items():
                out[f"{tag}.local.{k}"] = v.detach().clone()
            gathered = lay.gather(params).state_dict()
            out.update({f"{tag}.param.{k}": v for k, v in gathered.items()})
            if arch == "llama3.2-3b" and shape == TP_MESHES[0]:
                path = os.path.join(workdir, "tp_ckpt")
                ckpt_lib.save(path, TP_STEPS, {"params": params, "opt": opt}, layout=lay)
                back, _ = ckpt_lib.restore(path, {"params": params, "opt": opt}, layout=lay)
                out[f"{tag}.restored_equal"] = all(
                    torch.equal(a, b) for a, b in zip(back["params"].state_dict().values(),
                                                      params.state_dict().values()))
                # the files hold whole leaves: restored with no layout into
                # whole-shaped params, they are the gathered ones
                files, _ = ckpt_lib.restore(path, {"params": lay.gather(params)})
                out[f"{tag}.ckpt_whole_equal"] = all(
                    torch.equal(files["params"].state_dict()[k], v)
                    for k, v in gathered.items())

    for name, (arch, shape) in OV_CASES.items():
        cfg = get_smoke_config(arch)
        zoo = get_model(cfg)
        ov = attention_overrides(cfg, shape[-1], "train")
        mesh = make_mesh(shape, ("pod", "data", "model"), "cpu")
        step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=mesh, rules_overrides=ov)
        lay = step_fn.layout
        batches = [tp_batch(inp, arch, i) for i in range(TP_STEPS)]
        params, _, hist = _steps(step_fn, lay.shard(tree(arch)), opt_lib, ocfg, batches)
        out.update({f"ov.{name}.{k}": v for k, v in hist.items()})
        out.update({f"ov.{name}.spec.{k}": repr(v) for k, v in lay.specs.items()})
        out.update({f"ov.{name}.param.{k}": v for k, v in lay.gather(params).state_dict().items()})

    arch = MOE_ARCH
    for name, (shape, axes, fields) in MOE_AXES_CASES.items():
        zoo = get_model(dataclasses.replace(get_smoke_config(arch), **fields))
        mesh = make_mesh(shape, axes, "cpu")
        step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=mesh)
        lay = step_fn.layout
        batches = [tp_batch(inp, arch, i) for i in range(TP_STEPS)]
        from repro_torch.collectives import byte_ledger
        with byte_ledger() as ledger:
            params, _, hist = _steps(step_fn, lay.shard(tree(arch)), opt_lib, ocfg, batches)
        out.update({f"moe.{name}.{k}": v for k, v in hist.items()})
        out[f"moe.{name}.a2a_bytes"] = ledger.bytes("all_to_all")
        out.update({f"moe.{name}.param.{k}": v
                    for k, v in lay.gather(params).state_dict().items()})

    for name, (arch, n) in KV_CASES.items():
        zoo = get_model(get_smoke_config(arch))
        mesh = make_mesh((world // n, n), ("rep", "data"), "cpu")
        whole = zoo.init_cache(1, KV_CACHE, device="cpu")
        arts = make_serve_step(zoo, "cpu", mesh=mesh,
                               batch_example={"tokens": np.zeros((1, 1), np.int64)},
                               cache_example=whole, rules_overrides=KV_OVERRIDES)
        params = arts.param_layout.shard(ParamTree.from_state_dict(_whole_params(workdir, arch)))
        cache = arts.cache_layout.shard(whole)
        prompt = torch.from_numpy(inp[f"kv/{arch}/prompt"])
        for i in range(prompt.shape[1]):
            logits, cache = arts.decode_fn(params, cache, {"tokens": prompt[:, i:i + 1]})
            out[f"kv.{name}.decode{i}"] = logits
        for k, v in flatten(cache).items():
            if torch.is_tensor(v):
                out[f"kv.{name}.cache.{k}"] = v
    _save(workdir, "tp", rank, out)


# sequence parallelism over "model": (smoke arch, mesh, S, rules overrides or
# None for the dry run's attention_overrides)
SP_OVERRIDES = {"heads": None, "kv_heads": None, "seq": "model"}
SP_CASES = {"llama": ("llama3.2-3b", (1, 1, 8), 16, None),
            "gemma3": ("gemma3-4b", (1, 2, 4), 32, SP_OVERRIDES),
            "vlm": ("qwen2-vl-2b", (1, 2, 4), 16, SP_OVERRIDES),
            "whisper": ("whisper-large-v3", (1, 2, 4), 16, SP_OVERRIDES),
            "zamba2": ("zamba2-7b", (1, 2, 4), 16, SP_OVERRIDES),
            "xlstm": ("xlstm-125m", (1, 2, 4), 16, SP_OVERRIDES),
            "moe": ("moonshot-v1-16b-a3b", (1, 2, 4), 16, SP_OVERRIDES)}
SP_MODES = ("gspmd_fsdp", "manual_hier")
SP_STEPS = 2


def sp_modes(name):
    """The dp modes a case runs: the MoE family ``gspmd_fsdp`` only (the
    reference refuses ``manual_hier`` for it)."""
    return SP_MODES[:1] if name == "moe" else SP_MODES


def sp_overrides(cfg, shape, ov, kind="train"):
    from repro_torch.parallel.sharding import attention_overrides

    return dict(ov) if ov is not None else attention_overrides(cfg, shape[-1], kind)


def queues(slot, num_experts, capacity):
    """A routing's kept assignments as the reference's ``_route`` returns
    them: ``src_token`` (E, C), each slot's token (0 where empty), and
    ``slot_valid`` (E, C), from ``slot`` (T, K), each assignment's slot or
    E * C (dropped)."""
    T, K = slot.shape
    n = num_experts * capacity
    tokens = torch.arange(T).repeat_interleave(K)
    src = torch.zeros(n + 1, dtype=torch.int64).index_put((slot.reshape(-1),), tokens)[:-1]
    valid = torch.zeros(n + 1, dtype=torch.bool).index_put(
        (slot.reshape(-1),), torch.ones(T * K, dtype=torch.bool))[:-1]
    return src.reshape(num_experts, capacity), valid.reshape(num_experts, capacity)


def sp(rank, world, workdir):
    """Sequence parallelism over "model" for ``SP_CASES`` from the JAX
    inits in params.npz: ``SP_STEPS`` steps of each of ``sp_modes``
    (losses, grad norms, gathered params) and the sharded prefill's whole
    logits; the (query, key) lengths of every plain attention call of a
    rank (``common.masked_attention``); the positions that each block
    which mixes them takes and the heads its scan runs (``stream``); the
    MoE prefill's expert queues (``queues``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import common as C
    from repro_torch.models import hybrid, moe, ssm, transformer, xlstm_lm
    from repro_torch.models.common import ParamTree
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    ocfg = opt_lib.AdamWConfig(**OCFG)
    seen, stream, routes = [], [], []

    def wrap(mod, name, record):
        real = getattr(mod, name)

        def recorded(*args, **kw):
            record(*args, **kw)
            return real(*args, **kw)

        setattr(mod, name, recorded)
        return real

    wrap(C, "masked_attention", lambda q, k, *a, **kw: seen.append((q.shape[1], k.shape[1])))
    # a block's input: the residual stream between the blocks
    wrap(hybrid, "mamba2", lambda p, c, x, *a, **kw: stream.append(("block", x.shape[1])))
    for name in ("mlstm", "slstm"):
        wrap(xlstm_lm, name, lambda p, c, x, *a, **kw: stream.append(("block", x.shape[1])))
    wrap(transformer, "_ffn", lambda lp, c, h, *a, **kw: stream.append(("block", h.shape[1])))
    # what the block computes on: the gathered positions and the rank's heads
    wrap(ssm, "ssd_op", lambda x, *a, **kw: stream.append(("scan", x.shape[1], x.shape[2])))
    real_heads = ssm._heads_local

    def heads_local(*args):
        p, x, H = real_heads(*args)
        stream.append(("scan", x.shape[1], H))
        return p, x, H

    ssm._heads_local = heads_local
    wrap(transformer, "moe_ffn", lambda p, c, x, *a, **kw: stream.append(("moe", x.shape[1])))
    real_route = moe._route

    def route(*args, **kw):
        r = real_route(*args, **kw)
        routes.append(queues(r.slot, r.num_experts, r.capacity))
        return r

    moe._route = route
    out = {}
    for name, (arch, shape, _, ov) in SP_CASES.items():
        cfg = get_smoke_config(arch)
        zoo = get_model(cfg)
        mesh = make_mesh(shape, ("pod", "data", "model"), "cpu")
        batches = [tp_batch(inp, f"sp.{name}", i) for i in range(SP_STEPS)]
        for mode in sp_modes(name):
            tag = f"sp.{name}.{mode}"
            step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=mesh, dp_mode=mode,
                                      rules_overrides=sp_overrides(cfg, shape, ov))
            lay = step_fn.layout
            whole = ParamTree.from_state_dict(_whole_params(workdir, arch), requires_grad=True)
            seen.clear()
            stream.clear()
            params, _, hist = _steps(step_fn, lay.shard(whole), opt_lib, ocfg, batches)
            out.update({f"{tag}.{k}": v for k, v in hist.items()})
            out[f"{tag}.seq"] = ",".join(step_fn.plan.seq)
            out[f"{tag}.ssm"] = step_fn.plan.ssm
            out[f"{tag}.attn"] = np.array(sorted(set(seen))).reshape(-1, 2)
            out[f"{tag}.stream"] = repr(sorted(set(stream)))
            out.update({f"{tag}.param.{k}": v for k, v in lay.gather(params).state_dict().items()})
        prompt = {k: v for k, v in batches[0].items() if k != "targets"}
        arts = make_serve_step(zoo, "cpu", mesh=mesh, batch_example=prompt,
                               rules_overrides=sp_overrides(cfg, shape, ov, "prefill"))
        params = arts.param_layout.shard(ParamTree.from_state_dict(_whole_params(workdir, arch)))
        seen.clear()
        stream.clear()
        routes.clear()
        out[f"sp.{name}.prefill"] = arts.prefill_fn(params, prompt)
        out[f"sp.{name}.prefill.attn"] = np.array(sorted(set(seen))).reshape(-1, 2)
        out[f"sp.{name}.prefill.stream"] = repr(sorted(set(stream)))
        for i, (src, valid) in enumerate(routes):
            out[f"sp.{name}.prefill.route{i}.src"] = src
            out[f"sp.{name}.prefill.route{i}.valid"] = valid
    _save(workdir, "sp", rank, out)


def dry(rank, world, workdir):
    """The dry run's smoke cell run for real: llama3.2-3b-smoke's
    ``gspmd_fsdp`` step on (2, 2, 2) with CPU tensors, its FLOPs under
    ``FlopCounterMode``, its collectives under the byte ledger and its
    argument bytes from the blocks it holds."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.collectives import byte_ledger
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    zoo = get_model(get_smoke_config("llama3.2-3b"))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    ocfg = opt_lib.AdamWConfig()
    step_fn = make_train_step(zoo, ocfg, device="cpu", mesh=mesh)
    params = step_fn.layout.shard(zoo.init(0, device="cpu"))
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    batch = {"tokens": torch.from_numpy(inp["dry.tokens"]),
             "targets": torch.from_numpy(inp["dry.targets"])}
    flops = FlopCounterMode(display=False)
    with byte_ledger() as ledger, flops:
        step_fn(params, opt, batch)
    out = {"flops": flops.get_total_flops(),
           "param_bytes": sum(p.numel() * p.element_size() for p in params.parameters()),
           "moment_bytes": sum(t.numel() * t.element_size()
                               for t in list(opt.mu.values()) + list(opt.nu.values())),
           "ledger.op": [r.op for r in ledger.records],
           "ledger.axes": [",".join(r.axes) for r in ledger.records],
           "ledger.bytes": [r.nbytes for r in ledger.records]}
    _save(workdir, "dry", rank, out)


# the end-to-end twin at a small size (examples/torch/train_end_to_end.py run);
# the drill's steps a phase and checkpoint interval
E2E_CONFIG = dict(name="railx-tiny", family="dense", num_layers=2, d_model=64, heads=4,
                  kv_heads=2, d_ff=128, vocab=256, tie_embeddings=True)
E2E_STEPS = 4
DRILL_STEPS, DRILL_CKPT_EVERY = 4, 2


def example(name):
    """The module of ``examples/torch/<name>.py``, loaded by path as
    ``chip_smoke.py`` loads it."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from chip_smoke import example as load

    return load(name)


def _tree(workdir, prefix):
    from repro_torch.models.common import ParamTree

    init = np.load(os.path.join(workdir, "params.npz"))
    n = len(prefix) + 1
    return ParamTree.from_state_dict({k[n:]: torch.from_numpy(init[k].copy())
                                      for k in init.files if k.startswith(prefix + ".")})


def _history(res, key):
    return [h[key] for h in res.history]


def examples(rank, world, workdir):
    """The port's example twins on a world of 8 from the JAX inits in
    params.npz: the end-to-end ``run`` on (2, 2, 2) at ``E2E_CONFIG`` with
    each attention path, the drill's phase 1 on (4, 2), quickstart step 4 on
    (2, 2, 2), and serve_decode on (4, 2) under a port ``Tracer``."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig
    from repro_torch.obs import Tracer, tracing, validate_trace

    quiet = lambda *a, **k: None  # noqa: E731
    out = {}
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    e2e = example("train_end_to_end")
    for impl in ("ref", "flash"):
        cfg = dataclasses.replace(ModelConfig(**E2E_CONFIG), attn_impl=impl)
        res, floor = e2e.run(cfg, E2E_STEPS, mesh, "cpu", os.path.join(workdir, f"e2e_{impl}"),
                             quiet, init=_tree(workdir, "e2e"), log_every=1)
        out[f"e2e.{impl}.loss"] = _history(res, "loss")
        out[f"e2e.{impl}.grad_norm"] = _history(res, "grad_norm")
        out[f"e2e.{impl}.step"] = _history(res, "step")
        out["e2e.floor"] = floor

    ft = example("fault_tolerant_training")
    res = ft.phase1(make_mesh((4, 2), ("data", "model"), "cpu"), "cpu",
                    os.path.join(workdir, "drill"), DRILL_STEPS, DRILL_CKPT_EVERY, quiet,
                    init=_tree(workdir, "llama"), log_every=1)
    out["drill.p1.loss"] = _history(res, "loss")
    out["drill.p1.step"] = _history(res, "step")

    out["quick.loss"] = example("quickstart").train_step4(mesh, "cpu", log_fn=quiet,
                                                          init=_tree(workdir, "llama"))

    with tracing(Tracer()) as tracer:
        served = example("serve_decode").serve(make_mesh((4, 2), ("data", "model"), "cpu"),
                                               "cpu", quiet, init=_tree(workdir, "qwen"))
    out["serve.steps"] = served["steps"]
    out["serve.done"] = served["done"]
    out["serve.sampled"] = served["sampled"]
    out["serve.logits"] = torch.stack(served["logits"])
    out["serve.spans"] = tracer.phase_totals()["serve.decode_step"]["count"]
    out["serve.valid_spans"] = validate_trace(tracer.to_dict())["spans"]
    _save(workdir, "examples", rank, out)


def examples_shrunk(rank, world, workdir):
    """The drill's phase 2: a fresh world of 4 on (2, 2) restores phase 1's
    checkpoint with resharding and trains on."""
    ft = example("fault_tolerant_training")
    start, res = ft.phase2(make_mesh((2, 2), ("data", "model"), "cpu"), "cpu",
                           os.path.join(workdir, "drill"), DRILL_STEPS, DRILL_CKPT_EVERY,
                           lambda *a, **k: None, log_every=1)
    _save(workdir, "examples_shrunk", rank, {"drill.start": start,
                                             "drill.p2.loss": _history(res, "loss"),
                                             "drill.p2.step": _history(res, "step")})


if __name__ == "__main__":
    name, world, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    spawn_cpu_world(globals()[name], world, workdir)
