"""Chunkwise mLSTM kernel and its wrapper (counterpart of
``repro/kernels/mlstm/mlstm.py``).

``mlstm_fwd(q, k, v, i_gate, logf, chunk=64)`` -> h (B, S, H, D) with q
(pre-scaled by 1/sqrt(D)), k, v (B, S, H, D) and the input and log forget
gates (B, S, H); S a multiple of ``chunk`` (the model pads, with an input
gate of -1e30), as the TPU kernel asserts.

On CUDA tensors it launches ``csrc/mlstm_fwd.cu`` (built on first use, see
``kernels/build.py``) on the current stream and counts the call in
``LAUNCHES``: one count per call, which runs three CUDA kernels (each
tile's own contribution to the state, the serial combine into each tile's
incoming state, the outputs) through a scratch buffer the wrapper
allocates.  The kernel takes float32 only (the model casts to f32, as the
reference does), D up to 256 and chunk up to 256; the wrapper makes each
input contiguous (the model's already are).  On CPU tensors it computes the
plain version, ``ref.mlstm_chunked_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import build
from .ref import mlstm_chunked_ref

SOURCE = "mlstm/csrc/mlstm_fwd.cu"
MAX_D = 256      # (D x 64) slices of the state; the key tile fits one block
MAX_CHUNK = 256  # the kernels tile the rows their own way, whatever the chunk

# kernel launches since the count was last reset
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def launch_counts() -> Dict[str, int]:
    return {"mlstm_fwd": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _fn():
    fn = build.load(SOURCE).mlstm_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
        fn.restype = _I
    return fn


def _scratch_floats(B: int, S: int, H: int, D: int) -> int:
    fn = build.load(SOURCE).mlstm_fwd_scratch
    fn.argtypes, fn.restype = [_I] * 4, ctypes.c_longlong
    return fn(B, S, H, D)


def _check(q, k, v, i_gate, logf, chunk) -> None:
    ts = (q, k, v, i_gate, logf)
    if not (q.is_cuda and all(t.device == q.device for t in ts)):
        raise ValueError("q, k, v, i_gate and logf must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"mlstm_fwd takes float32 inputs, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, S, H, D = q.shape
    if i_gate.shape != (B, S, H) or logf.shape != (B, S, H):
        raise ValueError(f"the gates must be {(B, S, H)}, got {tuple(i_gate.shape)} "
                         f"and {tuple(logf.shape)}")
    if not (0 < chunk <= MAX_CHUNK and D <= MAX_D):
        raise ValueError(f"the kernel takes chunk up to {MAX_CHUNK} and D up to {MAX_D}, "
                         f"got chunk={chunk} D={D}")


def mlstm_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,
    logf: torch.Tensor,
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """q, k, v (B,S,H,D) [q pre-scaled]; i_gate, logf (B,S,H) -> (B,S,H,D)."""
    S = q.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}; pad the sequence")
    if q.device.type == "cpu":
        return mlstm_chunked_ref(q, k, v, i_gate, logf, chunk)
    _check(q, k, v, i_gate, logf, chunk)
    q, k, v, i_gate, logf = (t.contiguous() for t in (q, k, v, i_gate, logf))
    y = torch.empty_like(q)
    if y.numel() == 0:  # an empty grid is not a valid launch
        return y
    B, S, H, D = q.shape
    # 16-byte loads where every row starts on 16 bytes
    vec = int(D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v, y)))
    with torch.cuda.device(q.device):
        scratch = torch.empty(_scratch_floats(B, S, H, D), dtype=torch.float32, device=q.device)
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
                    logf.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, S, H, D, chunk, vec,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_fwd launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return y
