"""The chunkwise mLSTM as a differentiable op (counterpart of
``repro/kernels/mlstm/ops.py``): the forward is ``mlstm_fwd`` (the kernel on
the card, the chunked plain version on the CPU); the backward is the
gradient of the sequential ``mlstm_ref``, as the reference's ``custom_vjp``
differentiates its sequential oracle."""

from __future__ import annotations

import torch

from .mlstm import mlstm_fwd
from .ref import mlstm_ref


_META_OPS = []


def _meta_op():
    """``mlstm_fwd`` as an opaque op on the meta device, which holds shapes
    only: the dry run (``launch/roofline.py``) traces a call as one op, its
    inputs read and its output written once, and nothing is computed.
    Registered on first use."""
    if not _META_OPS:
        lib = torch.library.Library("repro_torch_mlstm_fwd", "DEF")
        lib.define("mlstm_fwd(Tensor q, Tensor k, Tensor v, Tensor i_gate, Tensor logf, int chunk)"
                   " -> Tensor")
        lib.impl("mlstm_fwd", lambda q, k, v, i_gate, logf, chunk: torch.empty_like(q), "Meta")
        _META_OPS.append(lib)
    return torch.ops.repro_torch_mlstm_fwd.mlstm_fwd


class _MLSTM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, i_gate, logf, chunk):
        ctx.save_for_backward(q, k, v, i_gate, logf)
        if q.device.type == "meta":  # the dry run's trace: shapes only
            return _meta_op()(q, k, v, i_gate, logf, chunk)
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
