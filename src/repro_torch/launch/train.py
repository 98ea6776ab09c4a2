"""Training launcher (counterpart of ``repro/launch/train.py``).

One process on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
        --steps 20 --device cpu

A world on a mesh runs ``--dp-mode`` ``gspmd_fsdp`` (the default, as in
the reference: params and AdamW state sharded, FSDP over "data", tensor
parallelism over "model") or ``manual_hier`` (replicated params, an
explicit RailX ``--schedule``).  Under ``torchrun`` (one rank per card,
NCCL; it reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``)

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --mesh 2,2,2 \\
        --axes pod,data,model

or, on the CPU, ``--devices N`` spawns N local gloo ranks (the counterpart
of the reference's forced host device count):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --devices 8 --mesh 2,2,2 --axes pod,data,model
    PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b \\
        --smoke --device cpu --devices 8 --mesh 2,2,2 --axes pod,data,model
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --devices 8 --mesh 2,2,2 --axes pod,data,model --dp-mode manual_hier \\
        --schedule hierarchical

Every rank takes the global batch's step and its own slice of it; rank 0
prints.  Under ``gspmd_fsdp`` every rank inits the whole params from the
seed and keeps its block; each checkpoint gathers whole leaves on every
rank and rank 0 writes them, and every rank resumes its blocks from them.
Under ``manual_hier`` rank 0 writes the checkpoints (params are
replicated) and every rank resumes from them; an MoE ``--arch`` (expert
parallelism over "data") runs ``gspmd_fsdp`` only, as in the reference.  Without ``--mesh`` a world
is one ``("data",)`` axis over all its ranks.  ``--device`` defaults to ``cuda``.  As in the
reference, the data's vocabulary is the model's, and its bigram table is
``vocab x vocab`` float64, so a full-vocab config needs that much host
memory.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn this many local gloo ranks on the CPU (needs --device cpu)")
    ap.add_argument("--mesh", default="", help="e.g. 2,2,2")
    ap.add_argument("--axes", default="", help="e.g. pod,data,model")
    ap.add_argument("--dp-mode", default="gspmd_fsdp", choices=("gspmd_fsdp", "manual_hier"))
    ap.add_argument("--schedule", default="hierarchical")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    from ..configs import get_config, get_smoke_config
    from ..train.train_step import check_dp_mode

    if args.devices or "RANK" in os.environ:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        check_dp_mode(cfg, args.dp_mode)  # before any rank starts
    if args.devices:
        if args.device != "cpu":
            raise SystemExit("--devices spawns gloo ranks on the CPU: pass --device cpu, "
                             "or run one rank per card under torchrun")
        from .mesh import spawn_cpu_world

        spawn_cpu_world(_train_rank, args.devices, args)
        return
    if "RANK" in os.environ:
        import torch.distributed as dist

        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        try:
            _train(args)
        finally:
            dist.destroy_process_group()
        return
    _train(args)


def _train_rank(rank: int, world: int, args: argparse.Namespace) -> None:
    _train(args)


def _train(args: argparse.Namespace) -> None:
    import torch.distributed as dist

    from .. import device as _device
    from ..configs import get_config, get_smoke_config
    from ..data.pipeline import DataConfig, SyntheticLM
    from ..models.model_zoo import get_model
    from ..parallel.sharding import param_layout
    from ..train import optimizer as opt_lib
    from ..train.train_step import make_train_step
    from ..train.trainer import CheckpointPolicy, StragglerMonitor, resume, train_loop
    from .mesh import make_mesh

    dev = _device.resolve(args.device)
    mesh = None
    rank = 0
    if dist.is_initialized():
        rank = dist.get_rank()
        if args.mesh:
            shape = tuple(int(x) for x in args.mesh.split(","))
            axes = tuple(args.axes.split(","))
        else:
            shape, axes = (dist.get_world_size(),), ("data",)
        mesh = make_mesh(shape, axes, dev)
    elif args.mesh:
        raise SystemExit("--mesh needs a world: run under torchrun, or pass --devices N")
    log = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    zoo = get_model(cfg)
    log(f"device: {dev}, model {cfg.name}")
    if mesh is not None:
        log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} ranks={dist.get_world_size()} "
            f"dp_mode={args.dp_mode} schedule={args.schedule}")

    data = SyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch)
    )
    ocfg = opt_lib.AdamWConfig(
        lr=args.lr, warmup_steps=max(5, args.steps // 20), total_steps=args.steps
    )
    step_fn = make_train_step(zoo, ocfg, microbatches=args.microbatches, device=dev,
                              mesh=mesh, dp_mode=args.dp_mode, schedule=args.schedule)
    params = zoo.init(0, device=dev)
    layout = None
    if mesh is not None and args.dp_mode == "gspmd_fsdp":
        layout = param_layout(zoo, mesh)
        params = layout.shard(params)
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        if rank == 0 or layout is not None:
            ckpt = CheckpointPolicy(args.ckpt_dir, every_steps=args.ckpt_every, layout=layout)
        if args.resume:
            params, opt, start = resume(args.ckpt_dir, params, opt, layout)
            log(f"resumed at step {start}")

    res = train_loop(
        step_fn, params, opt, data.batches(start), num_steps=args.steps,
        start_step=start, ckpt=ckpt, straggler=StragglerMonitor(), log_fn=log,
    )
    log(f"done: {res.steps_done} steps, final loss {res.last_metrics.get('loss'):.4f}")


if __name__ == "__main__":
    main()
