"""The train step (counterpart of ``repro/train/train_step.py``).

``make_train_step(zoo, opt_cfg, microbatches, device, mesh=...)`` returns
``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``:
value-and-grad of ``ModelZoo.loss`` through autograd, then
``optimizer.apply``.  With ``microbatches > 1`` the batch is cut into that
many equal slices along the batch dim (dim 1 of ``positions3``, dim 0 of the
rest); their gradients are summed in f32 and divided by the count, the loss
is the mean of theirs, and ``nll`` / ``aux`` are the last slice's, as in
the reference's scan.  With one microbatch the gradients stay in the param
dtype, as ``jax.value_and_grad`` returns them.  Metric keys: ``loss``,
``nll``, ``aux``, ``grad_norm`` (0-d tensors on the device) and ``lr`` (a
float).

With ``mesh=None`` the step runs in one process.  With a ``DeviceMesh``
(``launch.mesh.make_mesh``) it runs one of the reference's two modes;
``dp_mode`` defaults to ``gspmd_fsdp``, as there.  Each rank takes the
global batch and its slice of it over the ("pod", "data") axes, pod-major
(``positions3`` on dim 1; a batch dim that does not divide the DP size
stays whole; ``parallel.sharding.batch_specs_tree``).

* ``gspmd_fsdp`` (every family): params and AdamW moments are stored as
  each rank's block of the reference's layout (``param_layout(zoo, mesh)``:
  fsdp -> "data", heads / kv_heads / mlp / vocab -> "model"; build them with
  ``layout.shard`` or ``interop.params_from_jax(..., layout=)``).  Each layer
  gathers its leaves over "data" inside its (rematerialised) function and
  reduce-scatters their gradients; "model" runs tensor parallelism
  (``models/transformer.py``; the hybrid's Mamba2 and the xLSTM blocks split
  their heads, ``models/ssm.py``; whisper's three attentions, ``models/whisper.py``).  The loss is the global one (the masked sum
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
  each cut over the ranks.
* ``manual_hier``: params and AdamW state replicated over the DP axes and
  split over "model" as the rules say with ``fsdp`` and ``expert`` set to
  None (``param_layout(zoo, mesh, {"fsdp": None, "expert": None} |
  rules_overrides)``, the reference's partial-manual ``shard_map``, manual
  over the DP axes and automatic over "model"): attention heads, the MLP
  and the vocab run tensor-parallel (``zoo.shard_plan``), the rest whole on
  every "model" rank.  Each rank's loss is the mean over its own rows, as
  in the reference's manual region; the gradients (each rank's block, 1/|model|
  of a leaf split over "model") go through ``schedule`` and are divided by
  the DP size:

  * ``flat`` (or a mesh without "data"): one all-reduce over the DP axes;
  * ``hierarchical``: Eq. (8) leaf by leaf, RS(data) -> AR(pod) -> AG(data);
  * ``compressed``: each leaf flattened, padded to the data size, through
    ``compressed_hierarchical_all_reduce`` (int8 on the pod phase), unpadded.
    It needs a "pod" axis of size > 1: the reference, without one, passes
    the data axis as both intra and inter axes and returns a wrong sum.

  Loss, ``nll`` and ``aux`` are averaged over the DP axes; ``grad_norm`` is
  the whole gradient's (``sharded_global_norm``, a leaf whole over "model"
  counted once); then AdamW runs on the blocks.
  The MoE family is refused (``check_dp_mode``), as the reference cannot
  run it: its expert-parallel ``shard_map`` cannot nest in the manual
  region.

Both modes take the params and moments as each rank's blocks of
``step_layout(zoo, mesh, dp_mode, rules_overrides)`` (``layout.shard`` of
the whole leaves; on a world of one the blocks are the whole leaves).
``rules_overrides`` are the reference's: logical axis -> mesh axes, over
the default rules (``parallel.sharding.DEFAULT_RULES``).  An override that
moves a leaf (``heads``, ``kv_heads``, ``mlp``, ``vocab``, ``fsdp``,
``expert`` to None or another axis) changes the layout, and the plan
follows it: heads that stay whole run attention whole on every "model"
rank.  ``seq`` and ``kv_seq`` name no parameter.  ``seq -> "model"`` (set
by ``attention_overrides`` where the heads do not divide |model|) is the
reference's activation hint, which the port follows as sequence
parallelism for every family in both modes (the MoE family in
``gspmd_fsdp`` only): each rank takes its rows and then its block of
S/|model| consecutive positions of every batch entry
(``sharding.rank_batch``; |model| must divide S), computes with every
weight gathered whole (its gradient summed over "model"), gathers K and V
over "model" for attention, and sums the loss's masked sums over "model"
too (``models/transformer.py``).  The hybrid's Mamba2, the xLSTM's mLSTM
and sLSTM and the MoE layers gather the positions over "model" and run as
without the cut (``common.seq_gather``), then keep the rank's positions.

Params are updated in place, the counterpart of the reference's donated
buffers.

Tracing (``repro_torch.obs``, on while a tracer is installed or a
``torch.profiler`` records): each microbatch's ``zoo.loss`` runs in a
``train.fwd`` span and its ``backward()`` in ``train.bwd``; the f32
microbatch sum in ``train.grad_sum`` spans (the accumulator's fill, each
microbatch's add, the division); a mesh step's gradient collectives and
norm in ``train.grad_reduce``; ``optimizer.apply`` in ``train.optimizer``.
"""

from __future__ import annotations

import dataclasses
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
from ..obs import NULL_SPAN, get_tracer
from ..parallel.sharding import (
    Layout, cut_positions, entry_axes, param_layout, rank_batch, seq_axes,
)
from . import optimizer as opt_lib

StepFn = Callable[[torch.nn.Module, opt_lib.AdamWState, Mapping[str, Any]],
                  Tuple[torch.nn.Module, opt_lib.AdamWState, Dict[str, Any]]]


def to_device(batch: Mapping[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``dev``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=dev)
            for k, v in batch.items()}


def _batch_dim(key: str) -> int:
    """The batch dim of a batch entry: 1 for ``positions3`` (3, B, S), else 0."""
    return 1 if key == "positions3" else 0


def _split(batch: Dict[str, torch.Tensor], n: int) -> list:
    """``n`` equal slices of a batch along each entry's batch dim, as the
    reference's ``split_micro``."""
    if n == 1:
        return [batch]
    for key, v in batch.items():
        rows = v.shape[_batch_dim(key)]
        if rows % n:
            raise ValueError(f"batch of {rows} ({key}) does not split into {n} microbatches")
    return [dict(zip(batch, vals))
            for vals in zip(*(v.chunk(n, _batch_dim(k)) for k, v in batch.items()))]


class _GspmdFsdp:
    """The ``gspmd_fsdp`` step's layout and its collectives on ``mesh``."""

    def __init__(self, zoo: ModelZoo, mesh: DeviceMesh,
                 overrides: Optional[Dict[str, Any]] = None):
        self.mesh = mesh
        self.layout: Layout = step_layout(zoo, mesh, "gspmd_fsdp", overrides)
        self.plan = zoo.shard_plan(self.layout, seq_axes(mesh, overrides))
        sizes = self.layout.sizes
        self.intra = "data" if sizes.get("data", 1) > 1 else None
        self.inter = "pod" if sizes.get("pod", 1) > 1 else None

    def microbatches(self, batch: Dict[str, torch.Tensor], n: int) -> list:
        """Slices of the global batch, then each rank's rows of each (and,
        under sequence parallelism, its positions)."""
        return [rank_batch(self.mesh, mb, seq=self.plan.seq) for mb in _split(batch, n)]

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
    """The ``manual_hier`` step on ``mesh``: the layout over "model", and
    the DP half (this rank's rows, the gradient schedule, the metrics'
    mean)."""

    def __init__(self, zoo: ModelZoo, mesh: DeviceMesh, schedule: str,
                 overrides: Optional[Dict[str, Any]] = None):
        names = mesh.mesh_dim_names
        self.mesh = mesh
        self.layout: Layout = step_layout(zoo, mesh, "manual_hier", overrides)
        # each rank's loss is its own rows' mean, as in the reference's
        # manual region: no sum over the batch axes inside the loss (over
        # "model" under sequence parallelism, which is automatic there)
        self.plan = dataclasses.replace(
            zoo.shard_plan(self.layout, seq_axes(mesh, overrides)),
            dp=())
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
        """This rank's slice of the global batch (``batch_specs_tree``) and,
        under sequence parallelism, its positions, cut into ``n``
        microbatches."""
        out = {}
        for key, v in batch.items():
            bdim = _batch_dim(key)
            if v.shape[bdim] % self.dp_size == 0:
                rows = v.shape[bdim] // self.dp_size
                v = v.narrow(bdim, self.dp_rank * rows, rows)
            out[key] = v
        return _split(cut_positions(out, self.mesh, self.plan.seq), n)

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


def step_layout(zoo: ModelZoo, mesh, dp_mode: Optional[str] = None,
                rules_overrides: Optional[Dict[str, Any]] = None) -> Layout:
    """The layout of the params and moments that ``make_train_step(mesh=,
    dp_mode=, rules_overrides=)`` takes: the rules with ``rules_overrides``,
    and under ``manual_hier`` with ``fsdp`` and ``expert`` None unless the
    overrides name them (the reference's ``setdefault``)."""
    overrides = dict(rules_overrides or {})
    if (dp_mode or "gspmd_fsdp") == "manual_hier":
        overrides.setdefault("fsdp", None)
        overrides.setdefault("expert", None)
    return param_layout(zoo, mesh, overrides)


def make_train_step(
    zoo: ModelZoo,
    opt_cfg: opt_lib.AdamWConfig,
    microbatches: int = 1,
    device: _device.DeviceLike = None,
    *,
    mesh: Optional[DeviceMesh] = None,
    dp_mode: Optional[str] = None,
    schedule: str = "hierarchical",
    rules_overrides: Optional[Dict[str, Any]] = None,
) -> StepFn:
    """``dp_mode`` (with a mesh): ``gspmd_fsdp`` (the default) or
    ``manual_hier``; ``schedule`` is ``manual_hier``'s; ``rules_overrides``
    the reference's logical-rule overrides.  With a mesh the returned step
    has ``step_fn.layout``, its params' ``step_layout``, and ``step_fn.plan``,
    the rank's ``ShardPlan``."""
    dev = _device.resolve(device)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    dp = fsdp = None
    if mesh is not None:
        dp_mode = dp_mode or "gspmd_fsdp"
        if dp_mode == "gspmd_fsdp":
            fsdp = _GspmdFsdp(zoo, mesh, rules_overrides)
        elif dp_mode == "manual_hier":
            check_dp_mode(zoo.cfg, dp_mode)
            dp = _ManualHier(zoo, mesh, schedule, rules_overrides)
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
        trc = get_tracer()
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        acc = None
        if microbatches > 1:
            with (trc.span("train.grad_sum", cat="train") if trc.enabled else NULL_SPAN):
                acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for n, p in named.items()}
        losses = []
        plan = fsdp.plan if fsdp is not None else dp.plan if dp is not None else None
        for mb in slices:
            with (trc.span("train.fwd", cat="train") if trc.enabled else NULL_SPAN):
                loss, metrics = zoo.loss(params, mb, plan)
            with (trc.span("train.bwd", cat="train") if trc.enabled else NULL_SPAN):
                loss.backward()
            losses.append(loss.detach())
            if acc is not None:
                with (trc.span("train.grad_sum", cat="train") if trc.enabled else NULL_SPAN):
                    for n, p in named.items():
                        if p.grad is not None:
                            acc[n] += p.grad
                        p.grad = None
        if acc is None:
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in named.items()}
        else:
            with (trc.span("train.grad_sum", cat="train") if trc.enabled else NULL_SPAN):
                grads = {n: g / microbatches for n, g in acc.items()}
        gnorm = None
        if dp is not None or fsdp is not None:
            with (trc.span("train.grad_reduce", cat="train") if trc.enabled else NULL_SPAN):
                grads = (dp or fsdp).reduce_grads(grads)
                gnorm = opt_lib.sharded_global_norm(grads, (dp or fsdp).layout)
        with (trc.span("train.optimizer", cat="train") if trc.enabled else NULL_SPAN):
            params, opt_state, opt_metrics = opt_lib.apply(opt_cfg, opt_state, params, grads,
                                                           gnorm)
        for p in named.values():
            p.grad = None
        out = {"nll": metrics["nll"].detach(), "aux": metrics["aux"].detach(),
               "loss": torch.stack(losses).sum() / microbatches}
        if dp is not None:
            out = dp.mean(out)
        out.update(opt_metrics)
        return params, opt_state, out

    if mesh is not None:
        step_fn.layout = (fsdp or dp).layout
        step_fn.plan = (fsdp or dp).plan
    return step_fn
