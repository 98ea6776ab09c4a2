"""Quickstart, the PyTorch port's twin of ``examples/quickstart.py``: the
RailX toolkit in 60 seconds.

    PYTHONPATH=src python examples/torch/quickstart.py --device cpu --devices 8
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --mesh 1,1,1   # one card

1. Design a RailX installation and configure its topology (paper §3).
2. Map a 5D-parallel LLM workload onto it (paper §5).
3. Estimate collective times with the analytical model (paper §4.2).
4. Run five training steps of a small model with the paper's hierarchical
   collective schedule on a (pod, data, model) = (2, 2, 2) mesh.

Steps 1-3 run on the port's network core (``repro_torch.core``: plain
Python, no device) on rank 0 and print the reference's lines.  Step 4
trains the llama3.2-3b smoke model with ``dp_mode="manual_hier"`` and
``schedule="hierarchical"`` (params replicated over data and pod and split
over model, the gradients reduced by Eq. 8's reduce-scatter / all-reduce /
all-gather over data and pod) and prints each step's loss.  ``--device``
defaults to ``cuda``.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
from typing import Callable, List

STEPS = 5


def steps_1_to_3(log_fn: Callable[[str], None] = print) -> dict:
    """The reference's steps 1-3 on ``repro_torch.core``, printing its lines;
    -> the values they print from."""
    from repro_torch.core.analytical import t_allreduce_2d_ring, t_allreduce_hierarchical
    from repro_torch.core.cost import table3
    from repro_torch.core.mapping import (
        ModelSpec, ParallelismPlan, WorkloadShape, plan_dimension_split,
    )
    from repro_torch.core.topology import RailXConfig, table2_metrics

    # 1. hardware + topology
    cfg = RailXConfig(m=4, n=9, R=128)
    log_fn(f"RailX m={cfg.m} n={cfg.n} R={cfg.R}: {cfg.num_chips} chips, "
           f"{cfg.num_switches} OCSes")
    table2 = table2_metrics(cfg)
    for name, row in table2.items():
        log_fn(f"  {name:10s} scale={row['scale']:>10.0f} "
               f"diam={row['diameter_ho']:>3} bisect/chip={row['bisection_per_chip']:.2f}")
    rx = [r for r in table3() if r["name"] == "RailX7Mesh"][0]
    log_fn(f"  cost: {rx['cost_musd']}M$ for {rx['scale']} chips "
           f"({rx['cost_per_inject_x']}x FT cost/injection)")

    # 2. workload mapping
    model = ModelSpec(layers=80, hidden=8192, intermediate=28672,
                      vocab=128256, heads=64, kv_heads=8, experts=8, top_k=2)
    plan = ParallelismPlan(tp=16, cp=2, ep=8, dp=16, pp=4)
    shape = WorkloadShape(micro_batch=1, num_micro_batches=8, seq_len=8192)
    res = plan_dimension_split(RailXConfig(m=4, n=9, R=128), model, plan, shape)
    log_fn("\ndimension split (rails per logical dim):")
    for s in res.specs:
        log_fn(f"  {s.name:4s} phys={s.phys} scale={s.scale:<4d} rails={s.rails:<3d} "
               f"{s.interconnect}")

    # 3. collective estimates
    V, nB, alpha, k = 2 * 8192 * 28672 * 3 / 16, 9 * 100e9, 300e-9, 4.0
    ring = t_allreduce_2d_ring(4, 16, V, nB, alpha)
    hier = t_allreduce_hierarchical(4, 16, V, nB, alpha, k)
    log_fn(f"\nDP grad all-reduce estimate: 2D-ring {ring*1e3:.2f} ms vs "
           f"hierarchical {hier*1e3:.2f} ms ({ring/hier:.2f}x)")
    return {"cfg": cfg, "table2": table2, "cost": rx, "split": res, "ring": ring, "hier": hier}


def train_step4(mesh, device, steps: int = STEPS, log_fn: Callable[[str], None] = print, *,
                init=None) -> List[float]:
    """The reference's step 4 on this rank of ``mesh`` from ``init`` (the
    whole initial params; default ``zoo.init(0)``); -> the per-step losses."""
    from repro_torch import device as _device
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    dev = _device.resolve(device)
    cfg = get_smoke_config("llama3.2-3b")
    zoo = get_model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    dp_mode, schedule = "manual_hier", "hierarchical"
    step_fn = make_train_step(zoo, ocfg, device=dev, mesh=mesh, dp_mode=dp_mode,
                              schedule=schedule)
    params = step_fn.layout.shard(zoo.init(0, device=dev) if init is None else init)
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    log_fn(f"\ntraining {steps} steps with dp_mode={dp_mode}:")
    losses = []
    for step in range(steps):
        params, opt, m = step_fn(params, opt, data.batch(step))
        losses.append(float(m["loss"]))
        log_fn(f"  step {step}: loss {losses[-1]:.4f}")
    return losses


def _rank(rank: int, world: int, args: argparse.Namespace) -> None:
    from repro_torch.launch.mesh import make_mesh

    if rank == 0:
        steps_1_to_3()
    mesh = make_mesh(tuple(int(x) for x in args.mesh.split(",")), tuple(args.axes.split(",")),
                     args.device)
    train_step4(mesh, args.device, args.steps,
                print if rank == 0 else (lambda *a, **k: None))


def main(argv=None) -> None:
    from repro_torch.launch.mesh import run_world

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn this many local gloo ranks on the CPU (needs --device cpu)")
    ap.add_argument("--mesh", default="2,2,2")
    ap.add_argument("--axes", default="pod,data,model")
    args = ap.parse_args(argv)
    run_world(_rank, args.devices, args.device, args)


if __name__ == "__main__":
    main()
