"""The SSD scan as a differentiable op (counterpart of
``repro/kernels/ssd/ops.py``): the forward is ``ssd_fwd`` (the kernel on
the card, the chunked plain version on the CPU); the backward is the
gradient of the sequential ``ssd_ref``, as the reference's ``custom_vjp``
differentiates its sequential oracle."""

from __future__ import annotations

import torch

from .ref import ssd_ref
from .ssd import ssd_fwd


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A, chunk):
        ctx.save_for_backward(x, dt, Bm, Cm, A)
        return ssd_fwd(x, dt, Bm, Cm, A, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssd_ref(*inputs)
        grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def ssd(x, dt, Bm, Cm, A, chunk: int = 64) -> torch.Tensor:
    """x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,N), A (H,) -> y (B,S,H,P)."""
    return _SSD.apply(x, dt, Bm, Cm, A, chunk)
