"""Differentiable collectives for the sharded (``gspmd_fsdp``) step: each
is a ``torch.autograd.Function`` over one mesh axis whose backward is the
collective that the forward's transpose needs (the collectives XLA inserts
for the reference's GSPMD step):

  * ``gather``: all-gather a block along ``dim`` / reduce-scatter the
    gradient, for a weight whose gathered copy feeds different work on each
    rank (FSDP over "data"; a KV projection gathered over "model");
  * ``gather_whole``: all-gather / keep this rank's block of the gradient,
    for a weight whose gathered copy feeds the same work on every rank (a
    replicated block), so the gradient is whole everywhere;
  * ``copy_to``: identity / all-reduce the gradient (Megatron's f): a
    replicated tensor entering a tensor-parallel region;
  * ``reduce_from``: all-reduce / identity (Megatron's g): partial sums
    leaving a tensor-parallel region;
  * ``reduce_scatter``: reduce-scatter along ``dim`` / all-gather the
    gradient (``psum_scatter``; an MoE layer's partial expert outputs under
    ``token_scatter``);
  * ``all_to_all``: block i of ``split_dim`` to coordinate i, the blocks
    received concatenated on ``concat_dim`` / the reverse all-to-all (the
    expert-parallel dispatch and combine);
  * ``regroup``: a tensor split along a dim over some axes (and copied
    over the rest) -> split over other axes / the same move back, for a
    region whose ranks along an axis compute the same thing (a
    ``shard_map`` whose in_specs split the tokens or the experts unlike
    the step: the MoE layer with its EP axis on "model").

Over an axis of size 1 each is the identity and issues nothing.  Every
collective goes through ``schedules``, so the byte ledger records it.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from .schedules import (
    _all_gather_one, _all_reduce_, _reduce_scatter_one, all_gather_axis, all_to_all_axis,
    axis_size,
)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, partial):
        ctx.args = (mesh, axis, dim, partial)
        return _all_gather_one(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, partial = ctx.args
        if partial:
            return _reduce_scatter_one(g, mesh, axis, dim), None, None, None, None
        n = g.shape[dim] // axis_size(mesh, axis)
        return g.narrow(dim, mesh.get_local_rank(axis) * n, n), None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _all_reduce_(g.clone(memory_format=torch.contiguous_format), mesh, (axis,)), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format), mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _reduce_scatter_one(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _all_gather_one(g, mesh, axis, dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all_axis(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return all_to_all_axis(g, mesh, axis, concat_dim, split_dim), None, None, None, None


def _common(src: tuple, dst: tuple) -> int:
    n = 0
    while n < min(len(src), len(dst)) and src[n] == dst[n]:
        n += 1
    return n


def _regroup(x: torch.Tensor, mesh: DeviceMesh, moves: tuple) -> torch.Tensor:
    """For each (dim, src, dst) of ``moves``, blocks over ``src`` -> blocks
    over ``dst`` (axes major first, as a spec entry): the leading axes they
    share stay; the rest of every ``src`` is all-gathered first, then the
    rank's block over the rest of every ``dst`` is cut out (so no dim is cut
    over an axis that another dim still splits)."""
    for dim, src, dst in moves:
        rest = src[_common(src, dst):]
        if rest:
            x = all_gather_axis(x, mesh, rest, dim)
    for dim, src, dst in moves:
        rest = dst[_common(src, dst):]
        if rest:
            idx = 0
            for a in rest:
                idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
            n = x.shape[dim] // axis_size(mesh, rest)
            x = x.narrow(dim, idx * n, n).contiguous()
    return x


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, moves):
        ctx.args = (mesh, moves)
        return _regroup(x, mesh, moves)

    @staticmethod
    def backward(ctx, g):
        mesh, moves = ctx.args
        back = tuple((dim, dst, src) for dim, src, dst in moves)
        return _regroup(g.contiguous(), mesh, back), None, None


def regroup(x: torch.Tensor, mesh: DeviceMesh, moves) -> torch.Tensor:
    """For each (dim, src, dst) of ``moves``, ``x`` split along ``dim`` over
    the axes ``src`` -> split over ``dst``.  Ranks that hold the same block
    carry the same gradient (the ranks along an axis outside ``dst``
    compute the same thing), so the backward is the same move from ``dst``
    to ``src``, with no sum."""
    moves = tuple((d, tuple(s), tuple(t)) for d, s, t in moves if tuple(s) != tuple(t))
    if not moves:
        return x
    return _Regroup.apply(x, mesh, moves)


def gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim, True)


def gather_whole(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim, False)


def copy_to(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)
