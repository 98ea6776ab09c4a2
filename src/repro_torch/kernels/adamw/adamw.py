"""AdamW's multi-tensor kernels and their wrapper.

``train/optimizer.py`` calls these two on CUDA tensors (see
``csrc/adamw.cu`` for what each kernel computes and why):

* ``sum_sq(grads, root)``: the gradients' sum of squares, or its square
  root, as a 0-d f32 tensor: ``adamw_sum_sq`` (one partial a block, in f64)
  then ``adamw_norm_finalize`` (the partials summed in a fixed order);
* ``update(leaves, norm, hyper)``: AdamW on every leaf in place,
  ``adamw_update``, clipped by the norm it reads from device memory.

A step on one card launches three kernels: one ``adamw_sum_sq`` a group
of gradients of one dtype, one ``adamw_norm_finalize``, one
``adamw_update`` a group of leaves of one (param, grad) dtype pair; a group
longer than ``MAX_LEAVES`` (the leaves a launch's parameters hold) is cut
into several launches.  Params and gradients are bf16 or f32, moments
f32; every tensor contiguous, on one CUDA device.  Anything else raises:
the plain version (``optimizer._update_plain``, ``optimizer._sum_sq_plain``)
runs only on the CPU.  Each launch counts in ``LAUNCHES``; the launches run
inside operators of their own (``repro_torch_adamw::*``), so that a
profiler's range round a caller counts the kernels' time.  On the meta
device the same operators run and launch nothing, so that a dry run
(``launch/dryrun.py``) traces the card's path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Hashable, List, NamedTuple, Sequence, Tuple

import torch

from .. import build

SOURCE = "adamw/csrc/adamw.cu"
KERNELS = ("adamw_sum_sq", "adamw_norm_finalize", "adamw_update")

# kernel launches since the counts were last reset
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# csrc/adamw.cu's kThreads, kVec, kUnroll, kBlocksPerSm, kMaxLeaves
THREADS, VEC, UNROLL, BLOCKS_PER_SM, MAX_LEAVES = 256, 4, 4, 2, 64
TILE = THREADS * VEC * UNROLL  # elements a block takes at a time; never two leaves'
DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernels' dtype codes
META_SMS = 132  # an H100's SMs: the grid of a launch traced on the meta device

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _INTS = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    "adamw_sum_sq": [_I, _I, _LL, _LL, _P, _I, _P],
    "adamw_norm_finalize": [_P, _I, _P, _I, _P],
    "adamw_update": [_I, _I, _I, _LL, _LL, _LL, _LL, _LL, _INTS, _P] + [_F] * 10 + [_I, _P],
}


class Leaf(NamedTuple):
    p: torch.Tensor
    g: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    decay: bool  # decoupled weight decay (the param has ndim >= 2)


class Hyper(NamedTuple):
    """The update's f32 scalars, in ``adamw_update``'s order."""
    clip: float
    lr: float
    b1: float
    b2: float
    omb1: float  # 1 - b1, as the plain version's alpha
    omb2: float
    b1c: float   # 1 - b1^step, in f32
    b2c: float
    eps: float
    wd: float


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPES:
        raise TypeError(f"adamw: {what} must be bfloat16 or float32, got {t.dtype}")
    return DTYPES[t.dtype]


def tiles(numel: int) -> int:
    """The tiles of a leaf of ``numel`` elements (its last one ragged)."""
    return -(-numel // TILE)


def grid(n_tiles: int, sms: int) -> int:
    """Blocks of a launch: ``BLOCKS_PER_SM`` an SM, no more than its tiles,
    at least one (a norm launch writes a partial a block, tile or none)."""
    return max(1, min(n_tiles, sms * BLOCKS_PER_SM))


def groups(keys: Sequence[Hashable]) -> List[List[int]]:
    """The positions of ``keys``, grouped by key in order of first
    appearance, each group cut into runs of at most ``MAX_LEAVES``: one
    launch each."""
    by_key: Dict[Hashable, List[int]] = {}
    for i, k in enumerate(keys):
        by_key.setdefault(k, []).append(i)
    return [idx[i:i + MAX_LEAVES] for idx in by_key.values()
            for i in range(0, len(idx), MAX_LEAVES)]


def check(leaves: Sequence[Leaf]) -> torch.device:
    """The one device (CUDA, or meta) of every tensor of ``leaves``, which
    must be of the dtypes the kernels take, of their param's shape, and
    contiguous."""
    named = []
    for i, leaf in enumerate(leaves):
        dtype_code(leaf.p, f"p {i}")
        dtype_code(leaf.g, f"g {i}")
        for name, t in zip(Leaf._fields, leaf[:4]):
            if name in ("mu", "nu") and t.dtype != torch.float32:
                raise TypeError(f"adamw: {name} {i} must be float32, got {t.dtype}")
            if t.shape != leaf.p.shape:
                raise ValueError(f"adamw: {name} {i} has shape {tuple(t.shape)}, its param "
                                 f"{tuple(leaf.p.shape)}")
            named.append((f"{name} {i}", t))
    return _one_card(named)


def _one_card(named: Sequence[Tuple[str, torch.Tensor]]) -> torch.device:
    """The one device of the tensors, CUDA or meta, each contiguous."""
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"adamw: {name} must be contiguous")
    dev = None
    for name, t in named:
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"adamw: {name} must lie on a CUDA device, got {t.device}")
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"adamw: {name} lies on {t.device}, not {dev}")
    return dev


def table(tensors: Sequence[torch.Tensor]):
    """A ctypes array of the tensors' pointers."""
    return (ctypes.c_longlong * len(tensors))(*(t.data_ptr() for t in tensors))


def numels(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_longlong * len(tensors))(*(t.numel() for t in tensors))


def _sms(dev: torch.device) -> int:
    if dev.type == "meta":
        return META_SMS
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def sum_sq_launches(grads: Sequence[torch.Tensor], sms: int) -> List[Tuple[list, int, int]]:
    """``sum_sq``'s launches on a card of ``sms`` SMs: (the gradients, their
    dtype code, the grid) each, one group of a dtype at a time."""
    out = []
    for idx in groups([g.dtype for g in grads]):
        part = [grads[i] for i in idx]
        out.append((part, DTYPES[part[0].dtype], grid(sum(tiles(g.numel()) for g in part), sms)))
    return out


def update_launches(leaves: Sequence[Leaf], sms: int) -> List[Tuple[list, int, int, int]]:
    """``update``'s launches on a card of ``sms`` SMs: (the leaves, the
    params' and the gradients' dtype codes, the grid) each."""
    out = []
    for idx in groups([(leaf.p.dtype, leaf.g.dtype) for leaf in leaves]):
        part = [leaves[i] for i in idx]
        out.append((part, DTYPES[part[0].p.dtype], DTYPES[part[0].g.dtype],
                    grid(sum(tiles(leaf.p.numel()) for leaf in part), sms)))
    return out


_OPS: list = []


def _ops():
    """The launches as operators of their own (``repro_torch_adamw::*``,
    CUDA; on the meta device they do nothing): a profiler links a kernel
    to the operator that launched it, and a launch from Python under a
    ``record_function`` range alone to nothing, so that no range would count
    its time.  Registered on first use."""
    if not _OPS:
        lib = torch.library.Library("repro_torch_adamw", "DEF")
        lib.define("sum_sq(Tensor[] g, int code, int grid, Tensor(a!) partials, int at) -> ()")
        lib.define("norm_finalize(Tensor partials, int count, Tensor(a!) out, bool root) -> ()")
        lib.define("update(Tensor(a!)[] p, Tensor[] g, Tensor(b!)[] mu, Tensor(c!)[] nu, "
                   "int[] decay, Tensor norm, float[] hyper, int p_code, int g_code, "
                   "int grid) -> ()")
        lib.impl("sum_sq", _sum_sq_op, "CUDA")
        lib.impl("norm_finalize", _norm_finalize_op, "CUDA")
        lib.impl("update", _update_op, "CUDA")
        for name in ("sum_sq", "norm_finalize", "update"):
            lib.impl(name, _traced_op, "Meta")
        _OPS.append(lib)
    return torch.ops.repro_torch_adamw


def _traced_op(*args) -> None:
    """Every operator on the meta device: the tensors it writes are already
    there."""


def _sum_sq_op(g, code, grid_, partials, at):
    _launch("adamw_sum_sq", partials.device, code, len(g), table(g), numels(g),
            partials.data_ptr() + partials.element_size() * at, grid_)


def _norm_finalize_op(partials, count, out, root):
    _launch("adamw_norm_finalize", out.device, partials.data_ptr(), count, out.data_ptr(),
            int(root))


def _update_op(p, g, mu, nu, decay, norm, hyper, p_code, g_code, grid_):
    _launch("adamw_update", norm.device, p_code, g_code, len(p), table(p), table(g), table(mu),
            table(nu), numels(p), (ctypes.c_int * len(decay))(*decay), norm.data_ptr(), *hyper,
            grid_)


def sum_sq(grads: Sequence[torch.Tensor], root: bool = False) -> torch.Tensor:
    """Σ g² over every element of ``grads`` (its square root with ``root``),
    summed in f64, as a 0-d f32 tensor on their device."""
    grads = [g for g in grads if g.numel()]
    if not grads:
        raise ValueError("adamw: sum_sq of no elements")
    for i, g in enumerate(grads):
        dtype_code(g, f"g {i}")
    dev = _one_card([(f"g {i}", g) for i, g in enumerate(grads)])
    launches = sum_sq_launches(grads, _sms(dev))
    partials = torch.empty(sum(n for *_, n in launches), dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    at = 0
    for part, code, n in launches:
        _ops().sum_sq(part, code, n, partials, at)
        at += n
    _ops().norm_finalize(partials, at, out, root)
    return out


def update(leaves: Sequence[Leaf], norm: torch.Tensor, hyper: Hyper) -> None:
    """AdamW on every leaf, in place: p, mu and nu, from g clipped by the
    f32 ``norm`` (a one-element tensor on the leaves' device)."""
    leaves = [leaf for leaf in leaves if leaf.p.numel()]
    if not leaves:
        return
    dev = check(leaves)
    if norm.numel() != 1 or norm.dtype != torch.float32 or norm.device != dev:
        raise ValueError(f"adamw: the norm must be one float32 on {dev}, got {norm.dtype} "
                         f"{tuple(norm.shape)} on {norm.device}")
    for part, p_code, g_code, n in update_launches(leaves, _sms(dev)):
        _ops().update([lf.p.detach() for lf in part], [lf.g for lf in part],
                      [lf.mu for lf in part], [lf.nu for lf in part],
                      [int(lf.decay) for lf in part], norm, list(hyper), p_code, g_code, n)
