"""Public flash attention in model layout (counterpart of
``repro/kernels/flash_attention/ops.py``).

``flash_attention`` takes q (B, S, H, Dh), k/v (B, S, Hk, Dh) and views them
in kernel layout (no copy: the kernels take strides).  Without gradients it
runs the forward kernel.  When an input requires grad it runs ``_Flash``,
the counterpart of the reference's ``custom_vjp``: the forward that also
writes lse, and a backward through the dq and dk/dv kernels.  On CPU tensors
the same paths run the plain versions.  On the card a head_dim outside the
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.is_cuda:
            check_head_dim(q.shape[-1], BWD_HEAD_DIMS)
        out = _Flash.apply(qt, kt, vt, causal, window, scale, q_offset)
    else:
        out = flash_attention_fwd(qt, kt, vt, causal=causal, window=window, scale=scale,
                                  q_offset=q_offset)
    return out.transpose(1, 2)
