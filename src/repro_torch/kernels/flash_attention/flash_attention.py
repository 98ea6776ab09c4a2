"""Flash attention kernels and their wrappers (counterpart of
``repro/kernels/flash_attention/flash_attention.py``).

All three wrappers take kernel layout q (B, H, Sq, Dh), k/v (B, Hk, Skv, Dh):

* ``flash_attention_fwd`` -> o: ``csrc/flash_fwd.cu``;
* ``flash_attention_fwd_lse`` -> (o, lse (B, H, Sq) f32): the same kernel
  writing the logsumexp rows too;
* ``flash_attention_bwd`` -> (dq, dk, dv): ``csrc/flash_bwd.cu``, the dq
  kernel and the dk/dv kernel (which sums each kv head's query group
  itself).  delta = rowsum(o * do) is one torch reduction outside the
  kernels, as in the reference.

On CUDA tensors each launches its kernels (built on first use, see
``kernels/build.py``) on the current stream and counts every launch, one
counter per kernel (``LAUNCHES``, ``LSE_LAUNCHES``, ``DQ_LAUNCHES``,
``DKV_LAUNCHES``); on CPU tensors it computes the plain version from
``ref.py``.  Unlike the TPU kernels they take any Sq and Skv: the kernels
mask the ragged edge themselves.  The forward takes Dh in ``HEAD_DIMS``, the
backward in ``BWD_HEAD_DIMS`` (both include gemma3-4b's 320); any other Dh
raises ``ValueError`` on the card before a launch.

At bf16 the TMA / wgmma kernels (the forward, dq and dk/dv at Dh 64, 128
and 320) read their inputs through TMA tensor maps (the forward at Dh 64
and 128 writes o through one too); ``tma_map_geometry`` computes each map's
geometry here, with the boxes of ``TMA_FWD_ROWS`` / ``TMA_BWD_ROWS``, and
the C side checks the boxes against its tiles and encodes what it is given.

In f32 every kernel runs 3xTF32 on the tensor cores, and each may split its
work across blocks where its tiles alone would leave the card idle, then sum
the splits' partials in a second kernel in one fixed order: the forward and
dq split the keys (``f32_key_split``), dk/dv the group's heads and the q rows
(``f32_dkv_split``).  The wrappers allocate the partials' scratch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import build
from .ref import attention_bwd_ref, attention_fwd_lse_ref, attention_ref

SOURCE = "flash_attention/csrc/flash_fwd.cu"
BWD_SOURCE = "flash_attention/csrc/flash_bwd.cu"
HEAD_DIMS = (16, 32, 64, 128, 320)
BWD_HEAD_DIMS = (16, 32, 64, 128, 320)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The TMA / wgmma kernels' map boxes: 64 columns (128 bytes, the swizzle's
# width) by the rows of the tile each map loads, per head dim.  The forward's
# maps are q, k, v and o: 128-row q tiles (64 rows of o a consumer) and
# 128-key k / v tiles at Dh 64 and 128; at Dh 320 48-key k / v tiles and no
# o map (that kernel stores o from registers).
TMA_SLAB = 64
TMA_Q_ROWS, TMA_KV_ROWS, TMA_O_ROWS = 128, 128, 64
TMA_FWD_ROWS = {64: (TMA_Q_ROWS, TMA_KV_ROWS, TMA_KV_ROWS, TMA_O_ROWS),
                128: (TMA_Q_ROWS, TMA_KV_ROWS, TMA_KV_ROWS, TMA_O_ROWS),
                320: (TMA_Q_ROWS, 48, 48)}
# the backward's maps of (q, k, v, do) by (kernel, Dh): dq loads q / do
# tiles of an item's rows and k / v tiles of a step's keys, 128 and 128 at
# Dh 64 / 128, 64 and 48 at Dh 320; dk/dv loads q / do tiles of a step's
# rows and k / v tiles of an item's keys, 64 and 128 at Dh 64 / 128, 48 and
# 64 at Dh 320.
TMA_BWD_ROWS = {("flash_bwd_dq", 64): (128, 128, 128, 128),
                ("flash_bwd_dq", 128): (128, 128, 128, 128),
                ("flash_bwd_dq", 320): (64, 48, 48, 64),
                ("flash_bwd_dkv", 64): (64, 128, 128, 64),
                ("flash_bwd_dkv", 128): (64, 128, 128, 64),
                ("flash_bwd_dkv", 320): (48, 64, 64, 48)}

# The f32 forward's blocks (flash_fwd.cu, flash_fwd_tf32_kernel), and dq's
# (flash_bwd.cu, flash_bwd_dq_tf32_kernel): 64 q rows over the keys of one
# split, whose keys are a multiple of 32, so of the kernels' steps (32 keys,
# 16 at Dh 320); a split holds at least 64 keys.  dk/dv's
# (flash_bwd_dkv_tf32_kernel): a tile of keys (``f32_dkv_keys``) over the q
# rows of one split, a multiple of 32 (its steps are 32 rows, 16 at Dh 320),
# at least 64, and over every head of the group or one of them.
F32_ROWS, F32_CHUNK = 64, 32
F32_MIN_SPLIT = 2 * F32_CHUNK

# kernel launches since the counts were last reset
LAUNCHES = 0        # flash_fwd
LSE_LAUNCHES = 0    # flash_fwd writing lse (flash_fwd_lse)
DQ_LAUNCHES = 0     # flash_bwd_dq
DKV_LAUNCHES = 0    # flash_bwd_dkv

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def launch_counts() -> Dict[str, int]:
    return {"flash_fwd": LAUNCHES, "flash_fwd_lse": LSE_LAUNCHES,
            "flash_bwd_dq": DQ_LAUNCHES, "flash_bwd_dkv": DKV_LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES, LSE_LAUNCHES, DQ_LAUNCHES, DKV_LAUNCHES
    LAUNCHES = LSE_LAUNCHES = DQ_LAUNCHES = DKV_LAUNCHES = 0


def _fwd_fn():
    fn = build.load(SOURCE).flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 7 + [_LL] * 12 + [ctypes.c_float, _I, _I, _I, _P,
                                                          ctypes.POINTER(_LL), _P, _I]
        fn.restype = _I
    return fn


def _bwd_fn(name: str):
    fn = getattr(build.load(BWD_SOURCE), name)
    if fn.argtypes is None:
        n_out = 1 if name == "flash_bwd_dq" else 2
        fn.argtypes = [_P] * (6 + n_out) + [_I] * 7 + [ctypes.POINTER(_LL),
                                                      ctypes.c_float, _I, _I, _I, _P,
                                                      ctypes.POINTER(_LL), _P, _I, _I]
        fn.restype = _I
    return fn


def check_head_dim(Dh: int, head_dims: Tuple[int, ...] = HEAD_DIMS) -> None:
    if Dh not in head_dims:
        which = "backward" if head_dims == BWD_HEAD_DIMS else "forward"
        raise ValueError(f"head_dim {Dh} is not one of {head_dims}, the {which} kernel's range")


def _check(q, k, v, window, q_offset, head_dims=HEAD_DIMS, **more) -> None:
    """Raise on what the kernels do not take.  ``more`` are extra tensors of
    the backward: ``o``/``do`` shaped like q, ``lse`` f32 (B, H, Sq)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, Sq, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or k.shape[2] == 0 or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    check_head_dim(Dh, head_dims)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    like_q = {name: t for name, t in more.items() if name != "lse"}
    for name, t in like_q.items():
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must be a {q.dtype} tensor of shape {tuple(q.shape)} "
                             f"on {q.device}")
    if "lse" in more:
        lse = more["lse"]
        if (lse.device != q.device or lse.dtype != torch.float32
                or lse.shape != (B, H, Sq) or not lse.is_contiguous()):
            raise ValueError(f"lse must be a contiguous float32 tensor of shape {(B, H, Sq)}")
    for name, t in (("q", q), ("k", k), ("v", v), *like_q.items()):
        _check_layout(name, t)


def _check_layout(name: str, t: torch.Tensor) -> None:
    """The kernels move 16-byte vectors, and TMA takes 16-byte aligned bases
    and strides: raise unless ``t`` has them and a contiguous last dim."""
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dim, 16-byte aligned rows "
                         f"and strides that are multiples of {vec}; call .contiguous()")


def tma_map_geometry(name: str, t: torch.Tensor, rows: int) -> Tuple[int, ...]:
    """The 4-D TMA map of ``t`` (B, H, S, Dh), any strides ``_check_layout``
    takes, as the 11 integers the C side encodes (hopper.cuh, encode_map):
    dims (Dh, S, H, B) innermost first, byte strides (rows, heads, batches),
    box (64 columns, ``rows``, 1, 1); a tile is Dh / 64 such boxes.  The S
    extent is S itself, never S x H, so that TMA zero-fills rows past S on
    load and clips them on store even where the heads lie between the rows
    (a view of (B, S, H, Dh))."""
    _check_layout(name, t)
    B, H, S, Dh = t.shape
    sb, sh, ss, _ = t.stride()
    n = t.element_size()
    return (Dh, S, H, B, ss * n, sh * n, sb * n, TMA_SLAB, rows, 1, 1)


def _maps(names, tensors, rows):
    """The maps' geometry as a C entry point takes it, one map for each of
    ``rows`` (which may be fewer than the tensors); None without ``rows``."""
    if rows is None:
        return None
    fields = [f for name, t, r in zip(names, tensors, rows) for f in tma_map_geometry(name, t, r)]
    return (_LL * len(fields))(*fields)


def _fwd_maps(q, k, v, o):
    """The q, k, v (and, at Dh 64 / 128, o) maps' geometry as the C entry
    point takes it, or None where the forward takes no tensor map."""
    rows = TMA_FWD_ROWS.get(q.shape[3]) if q.dtype == torch.bfloat16 else None
    return _maps(("q", "k", "v", "o"), (q, k, v, o), rows)


def _bwd_maps(name, q, k, v, do):
    """The q, k, v and do maps' geometry for the backward kernel ``name``,
    or None where it takes no tensor map."""
    rows = TMA_BWD_ROWS.get((name, q.shape[3])) if q.dtype == torch.bfloat16 else None
    return _maps(("q", "k", "v", "do"), (q, k, v, do), rows)


def f32_key_split(B: int, H: int, Sq: int, Skv: int, sms: int) -> Tuple[int, int]:
    """(splits, keys a split) of the f32 forward: enough splits that its
    blocks, ``ceil(Sq / F32_ROWS) * H * B`` of them, number at least the
    card's ``sms``, but none shorter than ``F32_MIN_SPLIT`` keys; the keys a
    split are a multiple of ``F32_CHUNK``, and the splits cover Skv."""
    blocks = -(-Sq // F32_ROWS) * H * B
    want = max(1, min(-(-sms // blocks), -(-Skv // F32_MIN_SPLIT)))
    chunk = -(-(-(-Skv // want)) // F32_CHUNK) * F32_CHUNK
    return -(-Skv // chunk), chunk


def f32_split_scratch(splits: int, B: int, H: int, Sq: int, Dh: int) -> int:
    """f32 elements of the splits' scratch: each split's partial o (B, H,
    Sq, Dh) and its rows' (max, sum) pairs; none for one split."""
    return 0 if splits == 1 else splits * B * H * Sq * (Dh + 2)


def f32_dq_scratch(splits: int, B: int, H: int, Sq: int, Dh: int) -> int:
    """f32 elements of dq's scratch: each key split's partial dq (B, H, Sq,
    Dh); none for one split."""
    return 0 if splits == 1 else splits * B * H * Sq * Dh


def f32_dkv_keys(Dh: int) -> int:
    """Keys of an f32 dk/dv block: 4 strips of 16, 2 at Dh 320."""
    return 32 if Dh > 128 else 64


def f32_dkv_split(B: int, Hk: int, group: int, Sq: int, Skv: int, Dh: int,
                  sms: int) -> Tuple[int, int, int]:
    """(head splits, row splits, q rows a split) of the f32 dk/dv kernel.
    Where its blocks, ``ceil(Skv / f32_dkv_keys(Dh)) * Hk * B`` of them,
    number fewer than the card's ``sms``: a block a head of the group, then
    enough row splits that the blocks number at least ``sms``, none shorter
    than ``F32_MIN_SPLIT`` rows.  The rows a split are a multiple of
    ``F32_CHUNK``, and the splits cover Sq."""
    blocks = -(-Skv // f32_dkv_keys(Dh)) * Hk * B
    heads = group if blocks < sms else 1
    want = max(1, min(-(-sms // (blocks * heads)), -(-Sq // F32_MIN_SPLIT)))
    chunk = -(-(-(-Sq // want)) // F32_CHUNK) * F32_CHUNK
    return heads, -(-Sq // chunk), chunk


def f32_dkv_scratch(heads: int, splits: int, B: int, Hk: int, Skv: int, Dh: int) -> int:
    """f32 elements of dk/dv's scratch: each (row split, head split)'s
    partial dk and dv (B, Hk, Skv, Dh); none for one of each."""
    return 0 if heads * splits == 1 else 2 * heads * splits * B * Hk * Skv * Dh


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err < 0:
        raise RuntimeError(f"{name}: encoding a TMA tensor map failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _fwd(q, k, v, causal, window, scale, q_offset, with_lse: bool):
    _check(q, k, v, window, q_offset)
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    # same strides as q: a q viewed from (B, S, H, Dh) gives an o whose
    # transpose back is contiguous
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:  # nothing to compute; an empty grid is not a valid launch
        return o, lse
    part, chunk = None, 0
    if q.dtype == torch.float32:
        splits, chunk = f32_key_split(B, H, Sq, Skv, _sms(q))
        n = f32_split_scratch(splits, B, H, Sq, Dh)
        part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    with torch.cuda.device(q.device):
        err = _fwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _DTYPE_CODES[q.dtype], B, H, Hk, Sq, Skv, Dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale), int(causal), int(window or 0), int(q_offset), _stream(q),
            _fwd_maps(q, k, v, o), part.data_ptr() if part is not None else None, chunk,
        )
    _raise_on(err, "flash_fwd")
    return o, lse


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
    o, _ = _fwd(q, k, v, causal, window, scale, q_offset, with_lse=False)
    global LAUNCHES
    LAUNCHES += o.numel() > 0
    return o


def flash_attention_fwd_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (o like q, lse (B, H, Sq) f32); the forward the backward needs."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_fwd_lse_ref(q, k, v, causal=causal, window=window, scale=scale,
                                     q_offset=q_offset)
    o, lse = _fwd(q, k, v, causal, window, scale, q_offset, with_lse=True)
    global LSE_LAUNCHES
    LSE_LAUNCHES += o.numel() > 0
    return o, lse


def _bwd_launch(name, q, k, v, do, lse, delta, outs, dq_dk_dv, causal, window, scale, q_offset,
                part=None, chunk=0, head_splits=1):
    """Launch ``name`` writing ``outs``.  ``dq_dk_dv`` give the output strides
    the kernel takes; a slot it does not write may be any tensor of that
    shape.  f32: the split (``chunk``, ``head_splits``) and its scratch."""
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    strides = (_LL * 21)(*(s for t in (q, k, v, do, *dq_dk_dv) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _bwd_fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), _DTYPE_CODES[q.dtype],
            B, H, Hk, Sq, Skv, Dh, strides, float(scale), int(causal), int(window or 0),
            int(q_offset), _stream(q), _bwd_maps(name, q, k, v, do),
            part.data_ptr() if part is not None else None, chunk, head_splits,
        )
    _raise_on(err, name)


def bwd_dq(q, k, v, do, lse, delta, *, causal, window, scale, q_offset) -> torch.Tensor:
    """The dq kernel alone (arguments checked by ``flash_attention_bwd``)."""
    dq = torch.empty_like(q)
    part, chunk = None, 0
    if q.dtype == torch.float32:
        B, H, Sq, Dh = q.shape
        splits, chunk = f32_key_split(B, H, Sq, k.shape[2], _sms(q))
        n = f32_dq_scratch(splits, B, H, Sq, Dh)
        part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), (dq, k, v),
                causal, window, scale, q_offset, part, chunk)
    global DQ_LAUNCHES
    DQ_LAUNCHES += 1
    return dq


def bwd_dkv(q, k, v, do, lse, delta, *, causal, window, scale, q_offset):
    """The dk/dv kernel alone (arguments checked by ``flash_attention_bwd``)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part, chunk, heads = None, 0, 1
    if q.dtype == torch.float32:
        B, H, Sq, Dh = q.shape
        Hk, Skv = k.shape[1], k.shape[2]
        heads, splits, chunk = f32_dkv_split(B, Hk, H // Hk, Sq, Skv, Dh, _sms(q))
        n = f32_dkv_scratch(heads, splits, B, Hk, Skv, Dh)
        part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), (q, dk, dv),
                causal, window, scale, q_offset, part, chunk, heads)
    global DKV_LAUNCHES
    DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dq, dk, dv) in the dtypes of q, k, v; dk/dv (B, Hk, Skv, Dh)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window, scale=scale,
                                 q_offset=q_offset)
    _check(q, k, v, window, q_offset, BWD_HEAD_DIMS, o=o, do=do, lse=lse)
    if q.numel() == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    # (B, H, Sq), outside the kernels; contiguous whatever the strides of o
    delta = (o.float() * do.float()).sum(-1).contiguous()
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    dq = bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv
