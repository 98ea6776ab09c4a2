"""Flash attention forward: the hand-written CUDA kernel and its wrapper
(counterpart of ``repro/kernels/flash_attention/flash_attention.py``).

``flash_attention_fwd`` takes kernel layout q (B, H, Sq, Dh), k/v
(B, Hk, Skv, Dh).  On CUDA tensors it launches ``csrc/flash_fwd.cu`` (built
on first use, see ``kernels/build.py``) on the current stream and counts the
launch in ``LAUNCHES``; on CPU tensors it computes the plain version,
``attention_ref``.  Unlike the TPU kernel it takes any Sq and Skv: the
kernel masks the ragged edge itself.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build
from .ref import attention_ref

SOURCE = "flash_attention/csrc/flash_fwd.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last reset
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.flash_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i] + [ll] * 12 + [
            ctypes.c_float, i, i, i, p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, window, q_offset) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, _, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or k.shape[2] == 0 or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} is not one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    vec = 16 // q.element_size()  # the kernel moves 16-byte vectors
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim, 16-byte aligned rows "
                             f"and strides that are multiples of {vec}; call .contiguous()")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k/v: (B, Hk, Skv, Dh) with H % Hk == 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)
    _check(q, k, v, window, q_offset)
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    # same strides as q: a q viewed from (B, S, H, Dh) gives an o whose
    # transpose back is contiguous
    o = torch.empty_like(q)
    if o.numel() == 0:  # nothing to compute; an empty grid is not a valid launch
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, Hk, Sq, Skv, Dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale), int(causal), int(window or 0), int(q_offset), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return o
