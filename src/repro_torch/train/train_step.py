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
(``launch.mesh.make_mesh``) it runs one of the reference's two modes;
``dp_mode`` defaults to ``gspmd_fsdp``, as there.  Each rank takes the
global batch and its slice of it over the ("pod", "data") axes, pod-major
(``positions3`` on dim 1; a batch dim that does not divide the DP size
stays whole; ``parallel.sharding.batch_specs_tree``).

* ``gspmd_fsdp`` (dense and MoE families): params and AdamW moments are stored as
  each rank's block of the reference's layout (``param_layout(zoo, mesh)``:
  fsdp -> "data", heads / kv_heads / mlp / vocab -> "model"; build them with
  ``layout.shard`` or ``interop.params_from_jax(..., layout=)``).  Each layer
  gathers its leaves over "data" inside its (rematerialised) function and
  reduce-scatters their gradients; "model" runs tensor parallelism
  (``models/transformer.py``).  The loss is the global one (the masked sum
  over the global mask sum), a rank's gradient its share, so the batch axes
  only sum: a leaf split over "data" then all-reduces its 1/|data| block over
  "pod"; a leaf whole over "data" goes through Eq. (8), RS(data) ->
  AR(pod) -> AG(data), so that only 1/|data| of any gradient crosses "pod".
  ``grad_norm`` is the whole gradient's norm (``sharded_global_norm``).
  An MoE layer runs expert-parallel (``models/moe.py``): its expert leaves
  keep their "data" block, are fed by an all-to-all over "data", and their
  gradients are already the rank's own, so they are summed over "pod"
  only; the router, whole, is summed over the batch axes; ``aux`` is the
  layers' sum of each layer's aux averaged over the batch axes.
  Microbatches are slices of the global batch, as in the one-process step,
  each cut over the ranks.  Other families raise ``NotImplementedError``.
* ``manual_hier``: params and AdamW state replicated on every rank;
  ranks along "model" compute the same thing; the gradients go through
  ``schedule`` and are divided by the DP size:

  * ``flat`` (or a mesh without "data"): one all-reduce over the DP axes;
  * ``hierarchical``: Eq. (8) leaf by leaf, RS(data) -> AR(pod) -> AG(data);
  * ``compressed``: each leaf flattened, padded to the data size, through
    ``compressed_hierarchical_all_reduce`` (int8 on the pod phase), unpadded.
    It needs a "pod" axis of size > 1: the reference, without one, passes
    the data axis as both intra and inter axes and returns a wrong sum.

  Loss, ``nll`` and ``aux`` are averaged over the DP axes, then AdamW runs.
  The MoE family is refused (``check_dp_mode``), as the reference cannot
  run it: its expert-parallel ``shard_map`` cannot nest in the manual
  region.

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
from ..parallel.sharding import (
    Layout, batch_specs_tree, block_slices, entry_axes, param_layout,
)
from . import optimizer as opt_lib

StepFn = Callable[[torch.nn.Module, opt_lib.AdamWState, Mapping[str, Any]],
                  Tuple[torch.nn.Module, opt_lib.AdamWState, Dict[str, Any]]]


def to_device(batch: Mapping[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``dev``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=dev)
            for k, v in batch.items()}


def _split(batch: Dict[str, torch.Tensor], n: int) -> list:
    """``n`` equal slices of a batch along its first dim."""
    if n == 1:
        return [batch]
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} does not split into {n} microbatches")
    return [dict(zip(batch, vals)) for vals in zip(*(v.chunk(n, 0) for v in batch.values()))]


class _GspmdFsdp:
    """The ``gspmd_fsdp`` step's layout and its collectives on ``mesh``."""

    def __init__(self, zoo: ModelZoo, mesh: DeviceMesh):
        self.mesh = mesh
        # another family's param_specs raises, naming the ROADMAP item
        self.layout: Layout = param_layout(zoo, mesh)
        self.plan = zoo.shard_plan(self.layout)
        sizes = self.layout.sizes
        self.intra = "data" if sizes.get("data", 1) > 1 else None
        self.inter = "pod" if sizes.get("pod", 1) > 1 else None

    def microbatches(self, batch: Dict[str, torch.Tensor], n: int) -> list:
        """Slices of the global batch, then each rank's rows of each."""
        out = []
        for mb in _split(batch, n):
            specs, coord, sizes = batch_specs_tree(self.mesh, mb), self.layout.coord, \
                self.layout.sizes
            out.append({k: v[block_slices(v.shape, specs[k], sizes, coord)]
                        for k, v in mb.items()})
        return out

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sum each leaf's gradient over the batch axes that do not split it
        (the reduce-scatter over "data" of the split ones ran in the
        backward)."""
        out = dict(grads)
        whole = {}
        for key, g in grads.items():
            split = {a for e in self.layout.specs[key] for a in entry_axes(e)}
            if self.intra and self.intra not in split:
                whole[key] = g
            elif self.inter:
                out[key] = all_reduce_axis(g, self.mesh, self.inter)
        if whole and self.inter:
            out.update(tree_hierarchical_all_reduce(whole, self.mesh, (self.intra,),
                                                    (self.inter,)))
        elif whole:
            out.update({k: all_reduce_axis(g, self.mesh, self.intra) for k, g in whole.items()})
        return out


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

    def microbatches(self, batch: Dict[str, torch.Tensor], n: int) -> list:
        """This rank's slice of the global batch (``batch_specs_tree``), cut
        into ``n`` microbatches."""
        out = {}
        for key, v in batch.items():
            bdim = 1 if key == "positions3" else 0
            if v.shape[bdim] % self.dp_size == 0:
                rows = v.shape[bdim] // self.dp_size
                v = v.narrow(bdim, self.dp_rank * rows, rows)
            out[key] = v
        return _split(out, n)

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


def check_dp_mode(cfg, dp_mode: str) -> None:
    """Refuse what the reference cannot run: ``manual_hier`` with MoE layers
    (their expert-parallel ``shard_map`` cannot nest inside the step's
    manual region; the reference raises a mesh mismatch)."""
    if dp_mode == "manual_hier" and cfg.moe is not None:
        raise ValueError(
            f"{cfg.name}: dp_mode 'manual_hier' cannot run the MoE family (the reference's "
            "expert-parallel shard_map cannot nest in its manual region); use 'gspmd_fsdp'")


def make_train_step(
    zoo: ModelZoo,
    opt_cfg: opt_lib.AdamWConfig,
    microbatches: int = 1,
    device: _device.DeviceLike = None,
    *,
    mesh: Optional[DeviceMesh] = None,
    dp_mode: Optional[str] = None,
    schedule: str = "hierarchical",
) -> StepFn:
    """``dp_mode`` (with a mesh): ``gspmd_fsdp`` (the default) or
    ``manual_hier``; ``schedule`` is ``manual_hier``'s."""
    dev = _device.resolve(device)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    dp = fsdp = None
    if mesh is not None:
        dp_mode = dp_mode or "gspmd_fsdp"
        if dp_mode == "gspmd_fsdp":
            fsdp = _GspmdFsdp(zoo, mesh)
        elif dp_mode == "manual_hier":
            check_dp_mode(zoo.cfg, dp_mode)
            dp = _ManualHier(mesh, schedule)
        else:
            raise ValueError(f"unknown dp_mode {dp_mode!r}")

    def step_fn(params, opt_state, batch):
        batch = to_device(batch, dev)
        if fsdp is not None:
            slices = fsdp.microbatches(batch, microbatches)
        elif dp is not None:
            slices = dp.microbatches(batch, microbatches)
        else:
            slices = _split(batch, microbatches)
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        acc = None if microbatches == 1 else {
            n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named.items()}
        losses = []
        for mb in slices:
            if fsdp is not None:
                loss, metrics = zoo.loss(params, mb, fsdp.plan)
            else:
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
        gnorm = None
        if dp is not None:
            grads = dp.reduce_grads(grads)
        if fsdp is not None:
            grads = fsdp.reduce_grads(grads)
            gnorm = opt_lib.sharded_global_norm(grads, fsdp.layout)
        params, opt_state, opt_metrics = opt_lib.apply(opt_cfg, opt_state, params, grads, gnorm)
        for p in named.values():
            p.grad = None
        out = {"nll": metrics["nll"].detach(), "aux": metrics["aux"].detach(),
               "loss": torch.stack(losses).sum() / microbatches}
        if dp is not None:
            out = dp.mean(out)
        out.update(opt_metrics)
        return params, opt_state, out

    return step_fn
