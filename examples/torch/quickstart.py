"""Quickstart step 4, the PyTorch port's twin of step 4 of
``examples/quickstart.py``: five training steps of a small model with the
paper's hierarchical collective schedule on a (pod, data, model) = (2, 2, 2)
mesh.

    PYTHONPATH=src python examples/torch/quickstart.py --device cpu --devices 8
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --mesh 1,1,1   # one card

Steps 1-3 of the reference (design a RailX installation, map a 5D-parallel
workload onto it, estimate collective times) drive the framework-free
network twin (``repro.core``), which the port does not port: run
``examples/quickstart.py`` for them.  This step trains the llama3.2-3b smoke
model with ``dp_mode="manual_hier"`` and ``schedule="hierarchical"``
(params replicated over data and pod and split over model, the gradients
reduced by Eq. 8's reduce-scatter / all-reduce / all-gather over data and
pod) and prints each step's loss.
``--device`` defaults to ``cuda``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import argparse
from typing import Callable, List

STEPS = 5


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
