"""Gradient compression for the slow-axis reduction (counterpart of
``repro/collectives/compression.py``; beyond the paper).

* ``int8_compress`` / ``int8_decompress``: per-chunk symmetric int8 with an
  f32 scale per chunk (``max|x| / 127``, floored at 1e-12).  The ops run in
  the reference's order and ``torch.round`` rounds half to even as
  ``jnp.round`` does, so the int8 values are the reference's.
* ``ErrorFeedback`` / ``ef_compress``: the EF-SGD residual, so compression
  error does not bias convergence.
* ``compressed_hierarchical_all_reduce``: RS(intra) -> int8 all-gather over
  the inter axes, dequantised and summed in f32 in coordinate order ->
  AG(intra).  int8 partial sums would overflow, so the inter phase gathers
  instead of reducing.

Rank-local tensors and a ``DeviceMesh``, as in ``schedules``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from .schedules import AxisNames, _axes_tuple, all_gather_axis, reduce_scatter_axis


class Int8Compressed(NamedTuple):
    values: torch.Tensor   # int8 (chunks, chunk)
    scale: torch.Tensor    # f32 (chunks, 1)


def int8_compress(x: torch.Tensor, chunk: int = 4096) -> Int8Compressed:
    """Symmetric per-chunk int8 quantization of a flat f32/bf16 tensor."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(-1, chunk).to(torch.float32)
    scale = torch.amax(torch.abs(chunks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
    return Int8Compressed(q, scale)


def int8_decompress(c: Int8Compressed, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    flat = (c.values.to(torch.float32) * c.scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


class ErrorFeedback(NamedTuple):
    residual: torch.Tensor

    @staticmethod
    def init(shape, dtype: torch.dtype = torch.float32, device=None) -> "ErrorFeedback":
        return ErrorFeedback(torch.zeros(shape, dtype=dtype, device=device))


def ef_compress(g: torch.Tensor, ef: ErrorFeedback,
                chunk: int = 4096) -> Tuple[Int8Compressed, ErrorFeedback]:
    """Error-feedback int8: compress (g + residual), keep the new residual."""
    corrected = g.to(torch.float32) + ef.residual
    comp = int8_compress(corrected, chunk)
    approx = int8_decompress(comp, tuple(g.shape), torch.float32)
    return comp, ErrorFeedback(corrected - approx)


def compressed_hierarchical_all_reduce(x: torch.Tensor, mesh: DeviceMesh,
                                       intra_axes: AxisNames, inter_axes: AxisNames,
                                       chunk: int = 4096) -> torch.Tensor:
    """Hierarchical all-reduce with an int8 payload on the inter phase.
    ``x.shape[0]`` must divide by the intra size.

    The intra and inter axes must be disjoint: the reference, given the
    same axes for both (its train step on a mesh without ``pod``), adds
    each rank's reduce-scattered shard to the other ranks' different
    shards and returns a wrong sum.
    """
    intra, inter = _axes_tuple(intra_axes), _axes_tuple(inter_axes)
    if set(intra) & set(inter):
        raise ValueError(
            f"intra axes {intra} and inter axes {inter} overlap: the gather-then-sum "
            "would add different shards together (the reference's wrong sum on a mesh "
            "without a 'pod' axis)")
    shard = reduce_scatter_axis(x, mesh, intra, dim=0)
    comp = int8_compress(shard, chunk)
    vals = all_gather_axis(comp.values[None], mesh, inter, dim=0)     # (p, C, chunk) int8
    scales = all_gather_axis(comp.scale[None], mesh, inter, dim=0)    # (p, C, 1) f32
    summed = vals[0].to(torch.float32) * scales[0]
    for i in range(1, vals.shape[0]):
        summed = summed + vals[i].to(torch.float32) * scales[i]
    shard = summed.reshape(-1)[: shard.numel()].reshape(shard.shape).to(x.dtype)
    return all_gather_axis(shard, mesh, intra, dim=0)
