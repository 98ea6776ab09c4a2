"""Public flash attention in model layout (counterpart of
``repro/kernels/flash_attention/ops.py``).

``flash_attention`` takes q (B, S, H, Dh), k/v (B, S, Hk, Dh) and views them
in kernel layout (no copy: the kernels take strides).  Without gradients it
runs the forward kernel.  When an input requires grad it runs ``_Flash``,
the counterpart of the reference's ``custom_vjp``: the forward that also
writes lse, and a backward through the dq and dk/dv kernels.  On CPU tensors
the same paths run the plain versions; on meta tensors (the dry run's
trace) opaque ops of the kernels' shapes.  On the card a head_dim outside the
backward kernels' range (``BWD_HEAD_DIMS``) raises ``ValueError`` before the
forward runs when a gradient is asked for.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (
    BWD_HEAD_DIMS, check_head_dim, flash_attention_bwd, flash_attention_fwd,
    flash_attention_fwd_lse,
)


_META_OPS = []


def _meta_op(name: str):
    """The flash kernels as opaque ops on the meta device, which holds
    shapes only: the dry run (``launch/roofline.py``) traces each call as
    one op, its inputs read and its outputs written once, and nothing is
    computed.  Registered on first use."""
    if not _META_OPS:
        lib = torch.library.Library("repro_torch_flash", "DEF")
        lib.define("fwd(Tensor q, Tensor k, Tensor v) -> (Tensor, Tensor)")
        lib.define("bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do)"
                   " -> (Tensor, Tensor, Tensor)")
        lib.impl("fwd", lambda q, k, v: (torch.empty_like(q),
                                         q.new_empty(q.shape[:3], dtype=torch.float32)), "Meta")
        lib.impl("bwd", lambda q, k, v, o, lse, do: (torch.empty_like(q), torch.empty_like(k),
                                                     torch.empty_like(v)), "Meta")
        _META_OPS.append(lib)
    return getattr(torch.ops.repro_torch_flash, name)


class _MetaFlash(torch.autograd.Function):
    """``_Flash`` on the meta device: the kernels' shapes, through the
    opaque ops above."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _meta_op("fwd")(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return _meta_op("bwd")(*ctx.saved_tensors, do)


class _Flash(torch.autograd.Function):
    """Kernel layout in and out; saves q, k, v, o and lse for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal, window=window, scale=scale,
                                         q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Model layout: q (B, S, H, Dh), k/v (B, S, Hk, Dh) -> (B, S, H, Dh)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.device.type == "meta":  # the dry run's trace: shapes only
        out = _MetaFlash.apply(qt, kt, vt) if grad else _meta_op("fwd")(qt, kt, vt)[0]
        return out.transpose(1, 2)
    if grad:
        if q.is_cuda:
            check_head_dim(q.shape[-1], BWD_HEAD_DIMS)
        out = _Flash.apply(qt, kt, vt, causal, window, scale, q_offset)
    else:
        out = flash_attention_fwd(qt, kt, vt, causal=causal, window=window, scale=scale,
                                  q_offset=q_offset)
    return out.transpose(1, 2)
