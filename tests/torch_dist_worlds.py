"""Rank bodies of the port's gloo worlds for ``tests/test_torch_collectives.py``,
``tests/test_torch_dist_train.py``, ``tests/test_torch_fsdp.py`` and
``tests/test_torch_moe_ep.py``; imports
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
    Returns ``{name: stdout}``."""
    outs = {}
    with one_world_at_a_time(tmp_path_factory):
        for name, cmd in cmds.items():
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
    schedule, from the weights in params.npz."""
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
        params, losses, gnorms = _run(step_fn, _params(workdir), batches, TRAIN_STEPS, opt_lib,
                                      ocfg)
        out[f"{sched}.loss"] = losses
        out[f"{sched}.grad_norm"] = gnorms
        out.update({f"{sched}.param.{k}": v for k, v in params.state_dict().items()})
    _save(workdir, "train", rank, out)


def one(rank, world, workdir):
    """A world of one: the mesh steps (``manual_hier`` per schedule, and
    ``gspmd_fsdp``, the default) must be the one-process step; the
    refusals."""
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

    hybrid = get_model(get_smoke_config("zamba2-7b"))
    manual = dict(dp_mode="manual_hier")
    for tag, zoo, m, kw in (("pod1", _zoo(), mesh, dict(manual, schedule="compressed")),
                            ("nopod", _zoo(), data_only, dict(manual, schedule="compressed")),
                            ("fsdp", hybrid, mesh, dict(dp_mode="gspmd_fsdp")),
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
            if tag != "manual":
                params = lay.shard(params)
            step_fn = make_train_step(zoo, ocfg, micro, device="cpu", mesh=mesh, **kw)
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


if __name__ == "__main__":
    name, world, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    spawn_cpu_world(globals()[name], world, workdir)
