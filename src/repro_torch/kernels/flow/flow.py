"""The flow-level simulator's kernels and their wrappers.

``core/compiled_flow.py`` calls these four on the tensors of its
``CompiledNetwork`` (see ``csrc/flow.cu`` for what each computes):

* ``bfs_level``: one level of the batched BFS -> ``win`` (B n,);
* ``subtree_accumulate``: one depth's subtree counts into ``cnt`` and ``K``;
* ``orbit_gather``: the symmetry sweep's sum over the translation group;
* ``ordered_fold``: per-edge loads, each edge's contributions summed in the
  stream's order (bit-identical to the seed engine's loop).

On CUDA tensors each launches its kernel (``csrc/flow.cu``, built on first
use, see ``kernels/build.py``) on the current stream and counts the call in
``LAUNCHES``; a refused launch raises.  On CPU tensors each computes its
plain version in ``ref.py``.  The arrays keep the reference's types: keys,
``indptr``, edge ids, counts int64; ``nbr`` and ``edge_src`` int32; loads
float64; ``edge_ok`` bool.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import build
from . import ref

SOURCE = "flow/csrc/flow.cu"
KERNELS = ("flow_bfs_level", "flow_subtree_accumulate", "flow_orbit_gather", "flow_ordered_fold")

# kernel launches since the counts were last reset
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "flow_bfs_level": [_I, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _P],
    "flow_subtree_accumulate": [_P, _P, _L, _P, _P, _P, _L, _P],
    "flow_orbit_gather": [_P, _P, _P, _P, _L, _P, _P, _L, _L, _L, _P, _P],
    "flow_ordered_fold": [_P, _P, _L, _P, _P],
}


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _check(name: str, tensors: dict) -> torch.device:
    """All tensors on one CUDA device and contiguous, of the types the
    kernel takes."""
    want = {"int64": torch.int64, "int32": torch.int32, "float64": torch.float64,
            "bool": torch.bool}
    dev = None
    for arg, (t, dtype) in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must lie on a CUDA device, got {t.device}")
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{name}: {arg} lies on {t.device}, not {dev}")
        if t.dtype != want[dtype]:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


def bfs_level(
    bottom_up: bool,
    fkeys: torch.Tensor,          # (F,) int64 frontier keys b * n + u
    rank: torch.Tensor,           # (B n,) int64 rank in its source's frontier, else INF
    depth: torch.Tensor,          # (B n,) int32, -1 = undiscovered
    indptr: torch.Tensor,         # (n + 1,) int64
    nbr: torch.Tensor,            # (E,) int32
    rev_indptr: torch.Tensor,     # (n + 1,) int64
    rev_edge: torch.Tensor,       # (E,) int64
    edge_src: torch.Tensor,       # (E,) int32
    edge_slot: torch.Tensor,      # (E,) int64
    edge_ok: Optional[torch.Tensor],  # (E,) bool or None
    win: torch.Tensor,            # (B n,) int64, written whole
    n: int,
    stride: int,
) -> None:
    if win.device.type == "cpu":
        ref.bfs_level_ref(bottom_up, fkeys, rank, depth, indptr, nbr, rev_indptr, rev_edge,
                          edge_src, edge_slot, edge_ok, win, n, stride)
        return
    dev = _check("flow_bfs_level", {
        "fkeys": (fkeys, "int64"), "rank": (rank, "int64"), "depth": (depth, "int32"),
        "indptr": (indptr, "int64"), "nbr": (nbr, "int32"), "rev_indptr": (rev_indptr, "int64"),
        "rev_edge": (rev_edge, "int64"), "edge_src": (edge_src, "int32"),
        "edge_slot": (edge_slot, "int64"), "edge_ok": (edge_ok, "bool"), "win": (win, "int64")})
    size = win.numel()
    if rank.numel() != size or depth.numel() != size or size % n:
        raise ValueError(f"flow_bfs_level: rank, depth and win must hold B x n = {size} keys")
    _launch("flow_bfs_level", dev, int(bool(bottom_up)), fkeys.data_ptr(), fkeys.numel(),
            rank.data_ptr(), depth.data_ptr(), indptr.data_ptr(), nbr.data_ptr(),
            rev_indptr.data_ptr(), rev_edge.data_ptr(), edge_src.data_ptr(), edge_slot.data_ptr(),
            None if edge_ok is None else edge_ok.data_ptr(), win.data_ptr(), size, n, stride)


def subtree_accumulate(
    keys: torch.Tensor,      # (L,) int64: the keys of one depth
    epos: torch.Tensor,      # (L,) int64: their parent edges
    edge_src: torch.Tensor,  # (E,) int32
    cnt: torch.Tensor,       # (B n,) int64, updated in place
    K: torch.Tensor,         # (E,) int64, updated in place
    n: int,
) -> None:
    if K.device.type == "cpu":
        ref.subtree_accumulate_ref(keys, epos, edge_src, cnt, K, n)
        return
    dev = _check("flow_subtree_accumulate", {
        "keys": (keys, "int64"), "epos": (epos, "int64"), "edge_src": (edge_src, "int32"),
        "cnt": (cnt, "int64"), "K": (K, "int64")})
    if keys.shape != epos.shape:
        raise ValueError("flow_subtree_accumulate: keys and epos must have one shape")
    _launch("flow_subtree_accumulate", dev, keys.data_ptr(), epos.data_ptr(), keys.numel(),
            edge_src.data_ptr(), cnt.data_ptr(), K.data_ptr(), n)


def orbit_gather(
    C: torch.Tensor,        # (E,) int64 per-edge counts
    indptr: torch.Tensor,   # (n + 1,) int64
    re_u: torch.Tensor,     # (R,) int64 tails of the representative edges
    re_slot: torch.Tensor,  # (R,) int64 their CSR slots
    sx: torch.Tensor,       # (G,) int64 the group's translations
    sy: torch.Tensor,       # (G,) int64
    scale: int,
    m2: int,
) -> torch.Tensor:
    """-> K (R,) int64."""
    if C.device.type == "cpu":
        return ref.orbit_gather_ref(C, indptr, re_u, re_slot, sx, sy, scale, m2)
    dev = _check("flow_orbit_gather", {
        "C": (C, "int64"), "indptr": (indptr, "int64"), "re_u": (re_u, "int64"),
        "re_slot": (re_slot, "int64"), "sx": (sx, "int64"), "sy": (sy, "int64")})
    K = torch.zeros(re_u.numel(), dtype=torch.int64, device=dev)
    _launch("flow_orbit_gather", dev, C.data_ptr(), indptr.data_ptr(), re_u.data_ptr(),
            re_slot.data_ptr(), re_u.numel(), sx.data_ptr(), sy.data_ptr(), sx.numel(), scale,
            m2, K.data_ptr())
    return K


def ordered_fold(w_sorted: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """``w_sorted`` (L,) float64, the weights stably sorted by edge id;
    ``off`` (E + 1,) int64, each edge's run -> load (E,) float64."""
    if w_sorted.device.type == "cpu":
        return ref.ordered_fold_ref(w_sorted, off)
    dev = _check("flow_ordered_fold", {"w_sorted": (w_sorted, "float64"), "off": (off, "int64")})
    load = torch.empty(off.numel() - 1, dtype=torch.float64, device=dev)
    _launch("flow_ordered_fold", dev, w_sorted.data_ptr(), off.data_ptr(), load.numel(),
            load.data_ptr())
    return load
