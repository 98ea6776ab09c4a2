"""Public flash attention in model layout (counterpart of
``repro/kernels/flash_attention/ops.py``).

``flash_attention`` takes q (B, S, H, Dh), k/v (B, S, Hk, Dh), views them in
kernel layout (no copy: the kernel takes strides) and runs the forward.  This
slice ports the forward only: on the card, an input that requires grad
raises instead of returning a tensor with no gradient.  The backward kernels
come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_fwd


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
    if q.is_cuda and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention on CUDA is forward-only until the training slice "
            "ports flash_attention_fwd_lse / flash_attention_bwd"
        )
    out = flash_attention_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale, q_offset=q_offset,
    )
    return out.transpose(1, 2)
