"""The SSD scan as a differentiable op (counterpart of
``repro/kernels/ssd/ops.py``): the forward is ``ssd_fwd`` (the kernel on
the card, the chunked plain version on the CPU); the backward is the
gradient of the sequential ``ssd_ref``, as the reference's ``custom_vjp``
differentiates its sequential oracle."""

from __future__ import annotations

import torch

from .ref import ssd_ref
from .ssd import ssd_fwd


_META_OPS = []


def _meta_op():
    """``ssd_fwd`` as an opaque op on the meta device, which holds shapes
    only: the dry run (``launch/roofline.py``) traces a call as one op, its
    inputs read and its output written once, and nothing is computed.
    Registered on first use."""
    if not _META_OPS:
        lib = torch.library.Library("repro_torch_ssd_fwd", "DEF")
        lib.define("ssd_fwd(Tensor x, Tensor dt, Tensor Bm, Tensor Cm, Tensor A, int chunk)"
                   " -> Tensor")
        lib.impl("ssd_fwd", lambda x, dt, Bm, Cm, A, chunk: torch.empty_like(x), "Meta")
        _META_OPS.append(lib)
    return torch.ops.repro_torch_ssd_fwd.ssd_fwd


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A, chunk):
        ctx.save_for_backward(x, dt, Bm, Cm, A)
        if x.device.type == "meta":  # the dry run's trace: shapes only
            return _meta_op()(x, dt, Bm, Cm, A, chunk)
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
