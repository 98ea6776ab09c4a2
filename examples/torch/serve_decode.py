"""Batched serving, the PyTorch port's twin of ``examples/serve_decode.py``:
continuous-batching decode with the slot scheduler on a (data, model) mesh
with sharded KV caches.

    PYTHONPATH=src python examples/torch/serve_decode.py --device cpu --devices 8
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch/serve_decode.py
    PYTHONPATH=src python examples/torch/serve_decode.py --mesh 1,1 --trace serve.json

The qwen3-8b smoke model on a (4, 2) mesh, 4 slots, a cache of 64
positions; 6 requests of 4-token prompts drawn from ``RandomState(0)``, 8
new tokens each, decoded greedily.  As in the reference, the admission loop
("prefill-by-decode for brevity") writes each prompt token into the slot's
token in turn without a decode call in between, so only a prompt's last
token reaches the model.

``--trace PATH`` runs under ``repro_torch.obs.tracing(Tracer())`` and writes
the Chrome trace (rank 0's): one ``serve.decode_step`` span a decode call.
``--device`` defaults to ``cuda``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

SLOTS, CACHE = 4, 64
REQUESTS, PROMPT, MAX_NEW = 6, 4, 8


def serve(mesh, device, log_fn: Callable[[str], None] = print, *, init=None) -> Dict:
    """The reference's body on this rank of ``mesh`` from ``init`` (the whole
    params; default ``zoo.init(0)``); -> {"steps", "done", "sampled" (one
    (slots,) list a step), "logits" (one (slots, vocab) tensor a step)}."""
    import numpy as np
    import torch

    from repro_torch import device as _device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve.serve_step import BatchScheduler, Request, make_serve_step

    dev = _device.resolve(device)
    cfg = get_smoke_config("qwen3-8b")
    zoo = get_model(cfg)
    arts = make_serve_step(zoo, dev, mesh=mesh,
                           batch_example={"tokens": torch.zeros((SLOTS, 1), dtype=torch.long)},
                           cache_example=zoo.init_cache(SLOTS, CACHE, device=dev))
    params = arts.param_layout.shard(zoo.init(0, device=dev) if init is None else init)
    cache = arts.cache_layout.shard(zoo.init_cache(SLOTS, CACHE, device=dev))

    sched = BatchScheduler(slots=SLOTS, eos_id=1)
    rng = np.random.RandomState(0)
    for rid in range(REQUESTS):
        sched.submit(Request(rid=rid, prompt=rng.randint(2, cfg.vocab, PROMPT), max_new=MAX_NEW))

    # simple greedy decode over slots; empty slots feed token 0
    tokens = torch.zeros((SLOTS, 1), dtype=torch.long)
    steps = 0
    sampled_steps, logits_steps = [], []
    while not sched.idle and steps < 64:
        admitted = sched.admit()
        for req in admitted:
            # prefill-by-decode for brevity: feed the prompt token by token
            for t in req.prompt:
                slot = next(s for s, r in sched.active.items() if r is req)
                tokens[slot, 0] = int(t)
        logits, cache = arts.decode_fn(params, cache, {"tokens": tokens})
        last = logits[:, -1].float().cpu()
        sampled = last.argmax(-1).numpy()
        sched.step_tokens(sampled)
        sampled_steps.append(sampled.tolist())
        logits_steps.append(last)
        tokens = torch.tensor(sampled[:, None], dtype=torch.long)
        steps += 1

    done = REQUESTS - len(sched.queue) - len(sched.active)
    log_fn(f"decode steps: {steps}, requests completed: {done}/{REQUESTS}")
    if not (steps > 0 and done >= 4):
        raise AssertionError(f"{done} of {REQUESTS} requests completed in {steps} steps")
    log_fn("OK: batched serving works")
    return {"steps": steps, "done": done, "sampled": sampled_steps, "logits": logits_steps}


def _rank(rank: int, world: int, args: argparse.Namespace) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import NULL_TRACER, Tracer, tracing

    mesh = make_mesh(tuple(int(x) for x in args.mesh.split(",")), ("data", "model"), args.device)
    log = print if rank == 0 else (lambda *a, **k: None)
    with tracing(Tracer(process="serve_decode") if args.trace else NULL_TRACER) as tracer:
        serve(mesh, args.device, log)
    if args.trace and rank == 0:
        tracer.write(args.trace)
        log(f"trace: {args.trace}; {tracer.phase_totals()}")


def main(argv=None) -> None:
    from repro_torch.launch.mesh import run_world

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn this many local gloo ranks on the CPU (needs --device cpu)")
    ap.add_argument("--mesh", default="4,2", help="the (data, model) mesh")
    ap.add_argument("--trace", default="", help="write rank 0's Chrome trace here")
    args = ap.parse_args(argv)
    run_world(_rank, args.devices, args.device, args)


if __name__ == "__main__":
    main()
