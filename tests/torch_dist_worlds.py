"""Rank bodies of the port's gloo worlds for ``tests/test_torch_collectives.py``
and ``tests/test_torch_dist_train.py``; imports neither JAX nor ``repro``.

    python tests/torch_dist_worlds.py NAME WORLD WORKDIR

spawns WORLD local gloo ranks running ``NAME(rank, world, workdir)``; each
reads its inputs from ``WORKDIR/inputs.npz`` and writes
``WORKDIR/NAME_{rank}.npz``.  A rank's local input is block ``rank`` of
each input, and rank r sits at mesh coordinate ``unravel(r, shape)``, as
device r of a JAX mesh whose local blocks are ``P(all axes)``.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.collectives import compression as C  # noqa: E402
from repro_torch.collectives import schedules as S  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world  # noqa: E402

TRAIN_STEPS = 3
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)


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
        step_fn = make_train_step(_zoo(), ocfg, device="cpu", mesh=mesh, schedule=sched)
        params, losses, gnorms = _run(step_fn, _params(workdir), batches, TRAIN_STEPS, opt_lib,
                                      ocfg)
        out[f"{sched}.loss"] = losses
        out[f"{sched}.grad_norm"] = gnorms
        out.update({f"{sched}.param.{k}": v for k, v in params.state_dict().items()})
    _save(workdir, "train", rank, out)


def one(rank, world, workdir):
    """A world of one: the mesh step must be the one-process step, bit for
    bit; the refusals."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    batches = [{"tokens": inp[f"tokens{i}"], "targets": inp[f"targets{i}"]} for i in range(2)]
    ocfg = opt_lib.AdamWConfig(**OCFG)
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    out = {}
    runs = {"none": make_train_step(_zoo(), ocfg, device="cpu")}
    for sched in ("flat", "hierarchical"):
        runs[sched] = make_train_step(_zoo(), ocfg, device="cpu", mesh=mesh, schedule=sched)
    for name, step_fn in runs.items():
        params, losses, gnorms = _run(step_fn, _params(workdir), batches, 2, opt_lib, ocfg)
        out[f"{name}.loss"] = losses
        out[f"{name}.grad_norm"] = gnorms
        out.update({f"{name}.param.{k}": v for k, v in params.state_dict().items()})

    data_only = make_mesh((1,), ("data",), "cpu")
    for tag, m, kw in (("pod1", mesh, dict(schedule="compressed")),
                       ("nopod", data_only, dict(schedule="compressed")),
                       ("fsdp", mesh, dict(dp_mode="gspmd_fsdp")),
                       ("sched", mesh, dict(schedule="ring")),
                       ("mode", mesh, dict(dp_mode="auto"))):
        try:
            make_train_step(_zoo(), ocfg, device="cpu", mesh=m, **kw)
            out[f"refuse.{tag}"] = ""
        except (ValueError, NotImplementedError) as e:
            out[f"refuse.{tag}"] = f"{type(e).__name__}: {e}"
    _save(workdir, "one", rank, out)


if __name__ == "__main__":
    name, world, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    spawn_cpu_world(globals()[name], world, workdir)
