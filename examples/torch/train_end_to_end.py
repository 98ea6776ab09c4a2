"""End-to-end driver, the PyTorch port's twin of ``examples/train_end_to_end.py``:
train a ~100M-parameter LM for a few hundred steps on the synthetic bigram
corpus and check that the loss falls towards the corpus entropy floor.

    # the reference's 8 devices as 8 gloo ranks on the CPU (use --small there)
    PYTHONPATH=src python examples/torch/train_end_to_end.py --small --device cpu --devices 8
    # one rank per card (NCCL)
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch/train_end_to_end.py
    # one card: a world of one
    PYTHONPATH=src python examples/torch/train_end_to_end.py --mesh 1,1,1

The mesh is the reference's (pod x data x model = 2 x 2 x 2) unless
``--mesh`` / ``--axes`` say otherwise; FSDP + TP through the logical-axis
rules (``gspmd_fsdp``), 2 microbatches of gradient accumulation, a
checkpoint every 100 steps and straggler monitoring, as in the reference.
``--device`` defaults to ``cuda`` and raises without a card.  The corpus's
bigram table is ``vocab x vocab`` float64 (2.1 GB at railx-100m's 16384),
as in the reference.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Callable, Optional, Tuple

RAILX_36M = dict(name="railx-36m", family="dense", num_layers=8, d_model=512, heads=8,
                 kv_heads=4, d_ff=2048, vocab=8192, tie_embeddings=True)
RAILX_100M = dict(name="railx-100m", family="dense", num_layers=12, d_model=768, heads=12,
                  kv_heads=4, d_ff=3072, vocab=16384, tie_embeddings=True)


def railx_config(small: bool = False):
    """The reference's ~36M (``--small``, its CPU-friendly variant) or ~113M
    configuration, field for field."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**(RAILX_36M if small else RAILX_100M))


def corpus(cfg):
    """The reference's data: 16 sequences of 128 tokens a step from the
    bigram corpus of the model's vocabulary, and that corpus's entropy floor
    -> (SyntheticLM, floor in nats/token)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, optimal_nll

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=16)
    return SyntheticLM(dcfg), optimal_nll(dcfg)


def run(cfg, steps: int, mesh, device, ckpt_dir: str, log_fn: Callable[[str], None] = print, *,
        init=None, data: Optional[Tuple] = None, log_every: int = 20):
    """The reference's training body on this rank of ``mesh``: AdamW (lr 1e-3,
    20 warm-up steps, weight decay 0.01), ``gspmd_fsdp`` with 2 microbatches,
    ``train_loop`` with a checkpoint every 100 steps and a straggler monitor
    at 10x.  ``init`` is the whole initial params (default ``zoo.init(0)``),
    ``data`` a ``corpus(cfg)`` already built.  -> (TrainResult, floor)."""
    from repro_torch import device as _device
    from repro_torch.models.model_zoo import get_model
    from repro_torch.parallel.sharding import param_layout
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import CheckpointPolicy, StragglerMonitor, train_loop

    dev = _device.resolve(device)
    zoo = get_model(cfg)
    data, floor = data or corpus(cfg)
    log_fn(f"corpus entropy floor: {floor:.3f} nats/token")
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps, weight_decay=0.01)
    step_fn = make_train_step(zoo, ocfg, microbatches=2, device=dev, mesh=mesh,
                              dp_mode="gspmd_fsdp")
    layout = param_layout(zoo, mesh)
    params = layout.shard(zoo.init(0, device=dev) if init is None else init)
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    res = train_loop(
        step_fn, params, opt, data.batches(0), num_steps=steps,
        ckpt=CheckpointPolicy(ckpt_dir, every_steps=100, layout=layout),
        straggler=StragglerMonitor(threshold=10.0), log_every=log_every, log_fn=log_fn,
    )
    return res, floor


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="~36M variant (CPU-friendly; same code path)")
    ap.add_argument("--ckpt-dir", default="", help="default: a new temporary directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn this many local gloo ranks on the CPU (needs --device cpu)")
    ap.add_argument("--mesh", default="2,2,2")
    ap.add_argument("--axes", default="pod,data,model")
    return ap


def _rank(rank: int, world: int, args: argparse.Namespace, ckpt_dir: str) -> None:
    from repro_torch.launch.mesh import make_mesh

    log = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_mesh(tuple(int(x) for x in args.mesh.split(",")), tuple(args.axes.split(",")),
                     args.device)
    cfg = railx_config(args.small)
    log(f"model: {cfg.param_count() / 1e6:.1f}M params")
    res, floor = run(cfg, args.steps, mesh, args.device, ckpt_dir, log)
    first = res.history[0]["loss"]
    last = res.last_metrics["loss"]
    log(f"\nloss {first:.3f} -> {last:.3f} (floor {floor:.3f})")
    if not last < first - 0.5:
        raise AssertionError("expected a clear loss drop")
    log("OK: end-to-end training works")


def main(argv=None) -> None:
    from repro_torch.launch.mesh import run_world

    args = _parser().parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="railx_e2e_")
    run_world(_rank, args.devices, args.device, args, ckpt_dir)


if __name__ == "__main__":
    main()
