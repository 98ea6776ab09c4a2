"""The chunkwise mLSTM as a differentiable op (counterpart of
``repro/kernels/mlstm/ops.py``): the forward is ``mlstm_fwd`` (the kernel on
the card, the chunked plain version on the CPU); the backward is the
gradient of the sequential ``mlstm_ref``, as the reference's ``custom_vjp``
differentiates its sequential oracle."""

from __future__ import annotations

import torch

from .mlstm import mlstm_fwd
from .ref import mlstm_ref


class _MLSTM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, i_gate, logf, chunk):
        ctx.save_for_backward(q, k, v, i_gate, logf)
        return mlstm_fwd(q, k, v, i_gate, logf, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = mlstm_ref(*inputs)
        grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def mlstm(q, k, v, i_gate, logf, chunk: int = 64) -> torch.Tensor:
    """q, k, v (B,S,H,D) [q pre-scaled]; i_gate, logf (B,S,H) -> (B,S,H,D)."""
    return _MLSTM.apply(q, k, v, i_gate, logf, chunk)
