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
    expert-parallel dispatch and combine).

Over an axis of size 1 each is the identity and issues nothing.  Every
collective goes through ``schedules``, so the byte ledger records it.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from .schedules import (
    _all_gather_one, _all_reduce_, _reduce_scatter_one, all_to_all_axis, axis_size,
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
