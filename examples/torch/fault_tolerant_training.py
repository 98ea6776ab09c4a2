"""Fault-tolerance drill, the PyTorch port's twin of
``examples/fault_tolerant_training.py``: train -> node failure ->
Algorithm-2 reallocation -> elastic restart on a smaller mesh -> training
continues.

    # the reference's 8 devices as 8 gloo ranks, then a fresh world of 4
    PYTHONPATH=src python examples/torch/fault_tolerant_training.py --device cpu --devices 8
    # on cards: phase 1 on 8, then phase 2 on the 4 that are left (NCCL)
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch/fault_tolerant_training.py \\
        --phase 1 --ckpt-dir DIR
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch/fault_tolerant_training.py \\
        --phase 2 --ckpt-dir DIR
    # one card: both phases on worlds of one
    PYTHONPATH=src python examples/torch/fault_tolerant_training.py --mesh 1,1 --shrunk-mesh 1,1

  phase 1: a (data=4, model=2) mesh of the llama3.2-3b smoke model,
           ``gspmd_fsdp``, 10 steps, a checkpoint every 5;
  failure: nodes (0, 1) and (2, 3) of a 4 x 4 grid die -> ``plan_recovery``
           gives the largest healthy sub-grid;
  phase 2: a fresh world on a (data=2, model=2) mesh restores the latest
           checkpoint WITH resharding and trains 10 more steps; the loss
           must stay within 0.2 of phase 1's last.

Phase 2 is a new world started after phase 1's has exited, which is the
elastic restart itself: a ``DeviceMesh`` spans the whole world
(``repro_torch.launch.mesh.make_mesh``), so a smaller mesh needs a smaller
world.  Phase 1's last loss reaches phase 2 through ``drill.json`` in the
checkpoint directory.

As in the reference, phase 2's mesh is the hard-coded (2, 2), not the plan's
``mesh_shape`` (9, 2), and ``chips_per_node`` is not used by
``plan_recovery``.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Callable

FAILED_NODES = [(0, 1), (2, 3)]
STEPS, CKPT_EVERY, LOG_EVERY = 10, 5, 5


def _setup():
    """The reference's model, data and AdamW config."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib

    cfg = get_smoke_config("llama3.2-3b")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=60)
    return get_model(cfg), data, ocfg


def _train(zoo, data, ocfg, mesh, device, layout, params, opt, start: int, steps: int,
           ckpt_dir: str, ckpt_every: int, log_fn, log_every: int):
    """The reference's ``run``: ``steps`` steps from ``start`` on ``mesh``
    (the default ``gspmd_fsdp``), a checkpoint every ``ckpt_every``."""
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import CheckpointPolicy, train_loop

    step_fn = make_train_step(zoo, ocfg, device=device, mesh=mesh)
    return train_loop(
        step_fn, params, opt, data.batches(start), num_steps=start + steps, start_step=start,
        ckpt=CheckpointPolicy(ckpt_dir, every_steps=ckpt_every, layout=layout),
        log_every=log_every, log_fn=log_fn,
    )


def phase1(mesh, device, ckpt_dir: str, steps: int = STEPS, ckpt_every: int = CKPT_EVERY,
           log_fn: Callable[[str], None] = print, *, init=None, log_every: int = LOG_EVERY):
    """Train the full allocation from ``init`` (the whole initial params;
    default ``zoo.init(0)``) and write phase 1's last loss to ``drill.json``;
    -> TrainResult."""
    import torch.distributed as dist

    from repro_torch import device as _device
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train import optimizer as opt_lib

    dev = _device.resolve(device)
    zoo, data, ocfg = _setup()
    layout = param_layout(zoo, mesh)
    params = layout.shard(zoo.init(0, device=dev) if init is None else init)
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    log_fn(f"phase 1: {'x'.join(map(str, mesh.shape))} mesh")
    res = _train(zoo, data, ocfg, mesh, dev, layout, params, opt, 0, steps, ckpt_dir,
                 ckpt_every, log_fn, log_every)
    if dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "drill.json"), "w") as f:
            json.dump({"loss": res.last_metrics["loss"]}, f)
    dist.barrier()
    return res


def recovery_plan(log_fn: Callable[[str], None] = print):
    """Nodes (0, 1) and (2, 3) of the 4 x 4 grid fail: the reference's plan,
    printed as the reference prints it."""
    from repro_torch.launch.elastic import plan_recovery

    plan = plan_recovery(grid_side=4, failed_nodes=FAILED_NODES, chips_per_node=2, model_axis=2)
    log_fn(f"\nfailure: 2 nodes down -> healthy sub-grid "
           f"{plan.grid_side_rows}x{plan.grid_side_cols} (lost {plan.lost_fraction:.0%})")
    return plan


def phase2(mesh, device, ckpt_dir: str, steps: int = STEPS, ckpt_every: int = CKPT_EVERY,
           log_fn: Callable[[str], None] = print, *, log_every: int = LOG_EVERY):
    """The elastic restart on the shrunk ``mesh``: restore the latest
    checkpoint with resharding onto this rank's blocks, train ``steps``
    more steps, and hold the loss to phase 1's; -> (restored step,
    TrainResult)."""
    from repro_torch import device as _device
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainer import resume

    dev = _device.resolve(device)
    zoo, data, ocfg = _setup()
    layout = param_layout(zoo, mesh)
    params_like = layout.shard(zoo.init(0, device=dev))  # this rank's shapes, dtypes, device
    params_like.requires_grad_(True)
    opt_like = opt_lib.init(ocfg, params_like)
    params, opt, start = resume(ckpt_dir, params_like, opt_like, layout=layout)
    log_fn(f"\nphase 2: restored step {start} onto {'x'.join(map(str, mesh.shape))} mesh "
           f"(resharded)")
    res = _train(zoo, data, ocfg, mesh, dev, layout, params, opt, start, steps, ckpt_dir,
                 ckpt_every, log_fn, log_every)
    with open(os.path.join(ckpt_dir, "drill.json")) as f:
        loss1 = json.load(f)["loss"]
    loss2 = res.last_metrics["loss"]
    log_fn(f"\nloss before failure {loss1:.4f} -> after recovery {loss2:.4f}")
    if not loss2 < loss1 + 0.2:
        raise AssertionError("training regressed after recovery")
    log_fn("OK: elastic restart drill passed")
    return start, res


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="both", choices=("both", "1", "2"),
                    help="under torchrun, run phase 1 and then phase 2 on the smaller world")
    ap.add_argument("--steps", type=int, default=STEPS, help="steps of each phase")
    ap.add_argument("--ckpt-every", type=int, default=CKPT_EVERY)
    ap.add_argument("--ckpt-dir", default="", help="default: a new temporary directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn this many local gloo ranks on the CPU for phase 1 (needs "
                         "--device cpu); phase 2 spawns as many as its mesh has")
    ap.add_argument("--mesh", default="4,2", help="phase 1's (data, model) mesh")
    ap.add_argument("--shrunk-mesh", default="2,2", help="phase 2's (data, model) mesh")
    return ap


def _shape(text: str):
    return tuple(int(x) for x in text.split(","))


def _phase_rank(rank: int, world: int, args: argparse.Namespace, ckpt_dir: str,
                phase: str) -> None:
    from repro_torch.launch.mesh import make_mesh

    log = print if rank == 0 else (lambda *a, **k: None)
    if phase == "1":
        mesh = make_mesh(_shape(args.mesh), ("data", "model"), args.device)
        phase1(mesh, args.device, ckpt_dir, args.steps, args.ckpt_every, log)
        recovery_plan(log)
    else:
        mesh = make_mesh(_shape(args.shrunk_mesh), ("data", "model"), args.device)
        phase2(mesh, args.device, ckpt_dir, args.steps, args.ckpt_every, log)


def main(argv=None) -> None:
    import math

    from repro_torch.launch.mesh import run_world

    args = _parser().parse_args(argv)
    if args.phase == "both" and "RANK" in os.environ:
        raise SystemExit("under torchrun the world cannot shrink: run --phase 1, then --phase 2 "
                         "with as many ranks as --shrunk-mesh has")
    if args.phase == "2" and not args.ckpt_dir:
        raise SystemExit("--phase 2 restores from phase 1's --ckpt-dir")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="railx_ft_")
    if args.phase in ("both", "1"):
        run_world(_phase_rank, args.devices, args.device, args, ckpt_dir, "1")
    if args.phase in ("both", "2"):
        devices = math.prod(_shape(args.shrunk_mesh)) if args.devices else 0
        run_world(_phase_rank, devices, args.device, args, ckpt_dir, "2")


if __name__ == "__main__":
    main()
