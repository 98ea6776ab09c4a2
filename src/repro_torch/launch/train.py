"""Training launcher for one process on one device (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
        --steps 20 --device cpu

It takes the reference's flags that mean something on one card; the mesh
and device-count flags (``--devices --mesh --axes --dp-mode --schedule``)
wait for the distributed slice.  ``--device`` defaults to ``cuda``.  As in
the reference, the data's vocabulary is the model's, and its bigram table
is ``vocab x vocab`` float64, so a full-vocab config needs that much host
memory.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import device as _device
    from ..configs import get_config, get_smoke_config
    from ..data.pipeline import DataConfig, SyntheticLM
    from ..models.model_zoo import get_model
    from ..train import optimizer as opt_lib
    from ..train.train_step import make_train_step
    from ..train.trainer import CheckpointPolicy, StragglerMonitor, resume, train_loop

    dev = _device.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    zoo = get_model(cfg)
    print(f"device: {dev}, model {cfg.name}")

    data = SyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch)
    )
    ocfg = opt_lib.AdamWConfig(
        lr=args.lr, warmup_steps=max(5, args.steps // 20), total_steps=args.steps
    )
    step_fn = make_train_step(zoo, ocfg, microbatches=args.microbatches, device=dev)
    params = zoo.init(0, device=dev)
    params.requires_grad_(True)
    opt = opt_lib.init(ocfg, params)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointPolicy(args.ckpt_dir, every_steps=args.ckpt_every)
        if args.resume:
            params, opt, start = resume(args.ckpt_dir, params, opt)
            print(f"resumed at step {start}")

    res = train_loop(
        step_fn, params, opt, data.batches(start), num_steps=args.steps,
        start_step=start, ckpt=ckpt, straggler=StragglerMonitor(),
    )
    print(f"done: {res.steps_done} steps, final loss {res.last_metrics.get('loss'):.4f}")


if __name__ == "__main__":
    main()
