"""The train step, single process (counterpart of
``repro/train/train_step.py``).

``make_train_step(zoo, opt_cfg, microbatches, device)`` returns
``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``:
value-and-grad of ``ModelZoo.loss`` through autograd, then
``optimizer.apply``.  With ``microbatches > 1`` the batch is cut into that
many equal slices along its first dim; their gradients are summed in f32
and divided by the count, the loss is the mean of theirs, and ``nll`` /
``aux`` are the last slice's, as in the reference's scan.  With one
microbatch the gradients stay in the param dtype, as ``jax.value_and_grad``
returns them.  Metric keys: ``loss``, ``nll``, ``aux``, ``grad_norm``
(0-d tensors on the device) and ``lr`` (a float).

One process has no mesh: the reference's ``dp_mode`` and ``schedule`` (and
the collectives they pick) come with the distributed slice.  Params are
updated in place, the counterpart of the reference's donated buffers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from .. import device as _device
from ..models.model_zoo import ModelZoo
from . import optimizer as opt_lib

StepFn = Callable[[torch.nn.Module, opt_lib.AdamWState, Mapping[str, Any]],
                  Tuple[torch.nn.Module, opt_lib.AdamWState, Dict[str, Any]]]


def to_device(batch: Mapping[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``dev``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=dev)
            for k, v in batch.items()}


def make_train_step(
    zoo: ModelZoo,
    opt_cfg: opt_lib.AdamWConfig,
    microbatches: int = 1,
    device: _device.DeviceLike = None,
) -> StepFn:
    dev = _device.resolve(device)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def step_fn(params, opt_state, batch):
        batch = to_device(batch, dev)
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        if microbatches == 1:
            slices = [batch]
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into {microbatches} microbatches")
            slices = [dict(zip(batch, vals))
                      for vals in zip(*(v.chunk(microbatches, 0) for v in batch.values()))]
        acc = None if microbatches == 1 else {
            n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named.items()}
        losses = []
        for mb in slices:
            loss, metrics = zoo.loss(params, mb)
            loss.backward()
            losses.append(loss.detach())
            if acc is not None:
                for n, p in named.items():
                    if p.grad is not None:
                        acc[n] += p.grad
                    p.grad = None
        if acc is None:
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in named.items()}
        else:
            grads = {n: g / microbatches for n, g in acc.items()}
        params, opt_state, opt_metrics = opt_lib.apply(opt_cfg, opt_state, params, grads)
        for p in named.values():
            p.grad = None
        out = {"nll": metrics["nll"].detach(), "aux": metrics["aux"].detach()}
        out.update(opt_metrics)
        out["loss"] = torch.stack(losses).sum() / microbatches
        return params, opt_state, out

    return step_fn
