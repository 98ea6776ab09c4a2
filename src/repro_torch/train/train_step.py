"""The train step (counterpart of ``repro/train/train_step.py``).

``make_train_step(zoo, opt_cfg, microbatches, device, mesh=...)`` returns
``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``:
value-and-grad of ``ModelZoo.loss`` through autograd, then
``optimizer.apply``.  With ``microbatches > 1`` the batch is cut into that
many equal slices along its first dim; their gradients are summed in f32
and divided by the count, the loss is the mean of theirs, and ``nll`` /
``aux`` are the last slice's, as in the reference's scan.  With one
microbatch the gradients stay in the param dtype, as ``jax.value_and_grad``
returns them.  Metric keys: ``loss``, ``nll``, ``aux``, ``grad_norm``
(0-d tensors on the device) and ``lr`` (a float).

With ``mesh=None`` the step runs in one process.  With a ``DeviceMesh``
(``launch.mesh.make_mesh``) it is the reference's ``manual_hier`` step:
params and AdamW state replicated on every rank; each rank takes its slice
of the global batch over the ("pod", "data") axes, pod-major
(``positions3`` on dim 1; a batch dim that does not divide the DP size
stays whole); ranks along ``model`` compute the same thing (tensor
parallelism comes with ``gspmd_fsdp``); the gradients go through
``schedule`` and are divided by the DP size:

  * ``flat`` (or a mesh without "data"): one all-reduce over the DP axes;
  * ``hierarchical``: Eq. (8) leaf by leaf, RS(data) -> AR(pod) -> AG(data);
  * ``compressed``: each leaf flattened, padded to the data size, through
    ``compressed_hierarchical_all_reduce`` (int8 on the pod phase), unpadded.
    It needs a "pod" axis of size > 1: the reference, without one, passes
    the data axis as both intra and inter axes and returns a wrong sum.

Loss, ``nll`` and ``aux`` are averaged over the DP axes, then AdamW runs.
Params are updated in place, the counterpart of the reference's donated
buffers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import device as _device
from ..collectives.compression import compressed_hierarchical_all_reduce
from ..collectives.schedules import (
    _pad_to_multiple, all_reduce_axis, axis_size, tree_hierarchical_all_reduce,
)
from ..models.model_zoo import ModelZoo
from . import optimizer as opt_lib

StepFn = Callable[[torch.nn.Module, opt_lib.AdamWState, Mapping[str, Any]],
                  Tuple[torch.nn.Module, opt_lib.AdamWState, Dict[str, Any]]]


def to_device(batch: Mapping[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``dev``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=dev)
            for k, v in batch.items()}


class _ManualHier:
    """The DP half of the ``manual_hier`` step on ``mesh``."""

    def __init__(self, mesh: DeviceMesh, schedule: str):
        names = mesh.mesh_dim_names
        self.mesh = mesh
        self.dp_axes = tuple(a for a in ("pod", "data") if a in names)
        self.dp_size = axis_size(mesh, self.dp_axes)
        coord = dict(zip(names, mesh.get_coordinate()))
        self.dp_rank = 0
        for a in self.dp_axes:  # pod-major
            self.dp_rank = self.dp_rank * axis_size(mesh, a) + coord[a]
        self.intra = tuple(a for a in ("data",) if a in names)
        self.inter = tuple(a for a in ("pod",) if a in names)
        if schedule not in ("flat", "hierarchical", "compressed"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if schedule == "compressed" and self.intra and (
                not self.inter or axis_size(mesh, self.inter) == 1):
            raise ValueError(
                "schedule 'compressed' needs a 'pod' axis of size > 1 for its int8 phase; "
                f"the mesh {dict(zip(names, mesh.shape))} has none.  Without one the "
                "reference passes 'data' as both the intra and the inter axes and its "
                "gather-then-sum returns a wrong sum")
        self.schedule = "flat" if not self.intra else schedule

    def local_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slice of the global batch (``batch_specs_tree``)."""
        out = {}
        for key, v in batch.items():
            bdim = 1 if key == "positions3" else 0
            if v.shape[bdim] % self.dp_size == 0:
                n = v.shape[bdim] // self.dp_size
                v = v.narrow(bdim, self.dp_rank * n, n)
            out[key] = v
        return out

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mesh, dp = self.mesh, self.dp_size
        if self.schedule == "flat":
            return {k: all_reduce_axis(g, mesh, self.dp_axes) / dp for k, g in grads.items()}
        if self.schedule == "hierarchical":
            red = tree_hierarchical_all_reduce(grads, mesh, self.intra, self.inter)
            return {k: g / dp for k, g in red.items()}
        intra = axis_size(mesh, self.intra)

        def one(g):
            flat, pad = _pad_to_multiple(g.reshape(-1), intra, 0)
            out = compressed_hierarchical_all_reduce(flat, mesh, self.intra, self.inter)
            return out[: out.shape[0] - pad].reshape(g.shape) / dp

        return {k: one(g) for k, g in grads.items()}

    def mean(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """pmean over the DP axes, in f32, as one collective."""
        keys = list(metrics)
        total = all_reduce_axis(torch.stack([metrics[k].to(torch.float32) for k in keys]),
                                self.mesh, self.dp_axes) / self.dp_size
        return dict(zip(keys, total.unbind(0)))


def make_train_step(
    zoo: ModelZoo,
    opt_cfg: opt_lib.AdamWConfig,
    microbatches: int = 1,
    device: _device.DeviceLike = None,
    *,
    mesh: Optional[DeviceMesh] = None,
    dp_mode: str = "manual_hier",
    schedule: str = "hierarchical",
) -> StepFn:
    dev = _device.resolve(device)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    dp = None
    if mesh is not None:
        if dp_mode == "gspmd_fsdp":
            raise NotImplementedError(
                "dp_mode 'gspmd_fsdp' (FSDP2 over pod/data with TP on model) is ROADMAP "
                "Queue 1 item 2, not ported yet; use dp_mode='manual_hier'")
        if dp_mode != "manual_hier":
            raise ValueError(f"unknown dp_mode {dp_mode!r}")
        dp = _ManualHier(mesh, schedule)

    def step_fn(params, opt_state, batch):
        batch = to_device(batch, dev)
        if dp is not None:
            batch = dp.local_batch(batch)
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
        if dp is not None:
            grads = dp.reduce_grads(grads)
        params, opt_state, opt_metrics = opt_lib.apply(opt_cfg, opt_state, params, grads)
        for p in named.values():
            p.grad = None
        out = {"nll": metrics["nll"].detach(), "aux": metrics["aux"].detach(),
               "loss": torch.stack(losses).sum() / microbatches}
        if dp is not None:
            out = dp.mean(out)
        out.update(opt_metrics)
        return params, opt_state, out

    return step_fn
