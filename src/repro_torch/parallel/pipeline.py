"""Pipeline parallelism over a mesh axis, GPipe fill-drain (counterpart of
``repro/parallel/pipeline.py``).

RailX maps pipeline parallelism onto a rail-ring dimension (Table 4: P2P
ring traffic, the lightest of the parallelisms).  Stage s holds layer block
s; activations move one hop along the ``pipe`` ring each tick.  Where the
reference's ``jax.lax.ppermute`` moves them inside ``shard_map``, each rank
here sends to the next stage and receives from the previous one with
``isend`` / ``irecv`` issued together (``batch_isend_irecv``), so the ring
cannot deadlock.  A one-stage ring's hop is the identity, which
``ppermute`` takes in its stride while torch refuses a point-to-point op to
the rank itself: that hop is a local copy.

``pipeline_forward`` runs T = M + S - 1 ticks of a rotating microbatch
buffer, as the reference's (every stage computes every tick; stage 0
injects microbatch t while t < M, the last stage records microbatch
t - (S - 1)).  ``make_pipelined_apply`` wraps it: each rank takes its
stage's params from the stacked tree, and the last stage's outputs are
broadcast over the group (the reference masks and ``psum``s them).  As in
the reference, no model is wired into it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..collectives.schedules import axis_size


def _map(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``fn`` on every tensor of a tree of dicts (or ``ParamTree`` nodes),
    lists and tuples; the same tree of plain dicts back."""
    if not torch.is_tensor(tree) and hasattr(tree, "keys"):
        return {k: _map(tree[k], fn) for k in tree.keys()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _hop(y: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``y`` to the next stage of the ring; the previous stage's y back."""
    n = axis_size(mesh, axis)
    if n == 1:
        return y.clone()
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    send = y.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (idx + 1) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (idx - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                     micro_inputs: torch.Tensor, mesh: DeviceMesh,
                     axis: str = "pipe") -> torch.Tensor:
    """Every rank of ``axis`` calls it with its stage's params.

    micro_inputs: (M, ...) microbatches, read on stage 0 (other stages pass
    a tensor of the same shape).  Returns (M, ...): the outputs on the last
    stage, zeros elsewhere.  ``stage_fn`` must keep the microbatch shape."""
    S = axis_size(mesh, axis)
    idx = mesh.get_local_rank(axis)
    M = micro_inputs.shape[0]
    buf = torch.zeros_like(micro_inputs[0])
    outputs = torch.zeros_like(micro_inputs)
    for t in range(M + S - 1):
        x = micro_inputs[t] if idx == 0 and t < M else buf
        y = stage_fn(stage_params, x)
        if idx == S - 1 and t >= S - 1:
            outputs[t - (S - 1)] = y
        buf = _hop(y, mesh, axis)
    return outputs


def make_pipelined_apply(mesh: DeviceMesh, stage_fn: Callable, num_micro: int,
                         axis: str = "pipe") -> Callable:
    """``apply(params, inputs)``: params a tree whose leaves have a leading
    dim of the stage count (each rank uses its stage's slice); inputs
    (num_micro, micro_batch, ...), the same on every rank.  Returns the
    last stage's outputs on every rank."""
    def apply(params, inputs: torch.Tensor) -> torch.Tensor:
        if inputs.shape[0] != num_micro:
            raise ValueError(f"{inputs.shape[0]} microbatches, the apply was made for "
                             f"{num_micro}")
        idx = mesh.get_local_rank(axis)
        local = _map(params, lambda a: a[idx])
        outs = pipeline_forward(stage_fn, local, inputs, mesh, axis)
        S = axis_size(mesh, axis)
        if S > 1:
            group = mesh.get_group(axis)
            dist.broadcast(outs, dist.get_global_rank(group, S - 1), group=group)
        return outs

    return apply
