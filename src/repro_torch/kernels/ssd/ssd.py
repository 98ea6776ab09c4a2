"""Mamba2 SSD chunk-scan kernel and its wrapper (counterpart of
``repro/kernels/ssd/ssd.py``).

``ssd_fwd(x, dt, Bm, Cm, A, chunk=64)`` -> y (B, S, H, P) with x
(B, S, H, P), dt (B, S, H), Bm/Cm (B, S, N) shared by all heads, A (H,);
S a multiple of ``chunk`` (the model pads), as the TPU kernel asserts.

On CUDA tensors it launches ``csrc/ssd_fwd.cu`` (built on first use, see
``kernels/build.py``) on the current stream and counts the call in
``LAUNCHES``: one count per call, which runs two CUDA kernels (a pre-pass
that forms C B^T and splits C and B into TF32 pairs once per (batch,
tile), into a scratch buffer the wrapper allocates, then the scan).  The kernel takes float32 only (the model casts to f32, as the
reference does) with chunk up to 256 and P and N up to 128, the Pallas
kernel's documented range.  The wrapper makes each input contiguous (a
no-op for what the model passes, except the strided views of x, B and C
split from the conv output, which it copies once).  On CPU tensors it
computes the plain version, ``ref.ssd_chunked_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import build
from .ref import ssd_chunked_ref

SOURCE = "ssd/csrc/ssd_fwd.cu"
MAX_CHUNK, MAX_DIM = 256, 128  # chunk; P and N

# kernel launches since the count was last reset
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def launch_counts() -> Dict[str, int]:
    return {"ssd_fwd": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _fn():
    fn = build.load(SOURCE).ssd_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 7 + [_P]
        fn.restype = _I
    return fn


def _scratch_floats(B: int, S: int, N: int) -> int:
    fn = build.load(SOURCE).ssd_fwd_scratch
    fn.argtypes, fn.restype = [_I, _I, _I], ctypes.c_longlong
    return fn(B, S, N)


def _check(x, dt, Bm, Cm, A, chunk) -> None:
    ts = (x, dt, Bm, Cm, A)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("x, dt, Bm, Cm and A must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_fwd takes float32 inputs, got {[t.dtype for t in ts]}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, S, H) or Bm.shape != (B, S, N) or Cm.shape != (B, S, N)
            or A.shape != (H,)):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} A {tuple(A.shape)}")
    if not (0 < chunk <= MAX_CHUNK and P <= MAX_DIM and N <= MAX_DIM):
        raise ValueError(f"the kernel takes chunk up to {MAX_CHUNK} and P and N up to "
                         f"{MAX_DIM}, got chunk={chunk} P={P} N={N}")


def ssd_fwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    A: torch.Tensor,
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,N), A (H,) -> y (B,S,H,P)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}; pad the sequence")
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, Bm, Cm, A, chunk)[0]
    _check(x, dt, Bm, Cm, A, chunk)
    x, dt, Bm, Cm, A = (t.contiguous() for t in (x, dt, Bm, Cm, A))
    y = torch.empty_like(x)
    if y.numel() == 0:  # an empty grid is not a valid launch
        return y
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    # 16-byte loads of B and C where their rows start on 16 bytes
    vec = int(N % 4 == 0 and Bm.data_ptr() % 16 == 0 and Cm.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        scratch = torch.empty(_scratch_floats(B, S, N), dtype=torch.float32, device=x.device)
        err = _fn()(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
                    y.data_ptr(), scratch.data_ptr(), B, S, H, P, N, chunk, vec,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_fwd launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return y
