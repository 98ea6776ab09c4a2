"""The flow-level simulator's kernels and their wrappers.

``core/compiled_flow.py`` calls these four on the tensors of its
``CompiledNetwork`` (see ``csrc/flow.cu`` for what each computes):

* ``bfs_level``: one whole level of the batched BFS, ranked: the new level
  in the BFS queue, its depths, ranks and child offsets, and the sizes the
  host reads (one read a level);
* ``subtree_accumulate``: one level's subtree counts, each parent's
  children summed in level order, into ``cnt`` and ``K``;
* ``orbit_gather``: the symmetry sweep's sum over the translation group,
  read as one column sum of the count table;
* ``ordered_fold``: per-edge loads, each edge's contributions summed in the
  stream's order (bit-identical to the seed engine's loop), the runs staged
  through shared memory.

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
    "flow_bfs_level": [_I, _I, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _L, _P, _P, _L, _L, _L, _P],
    "flow_subtree_accumulate": [_P, _P, _P, _L, _L, _P, _P, _P, _L, _P],
    "flow_orbit_gather": [_P, _P, _L, _L, _L, _L, _P, _P],
    "flow_ordered_fold": [_P, _L, _P, _L, _P, _P],
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


# frontier entries a tile of flow_bfs_level's scan (flow.cu kTile)
SCAN_TILE = 1024


def mask_words(stride: int) -> int:
    """64-bit words of one frontier entry's child mask: a bit a slot, and
    the slots run to ``stride - 2``."""
    return (stride + 62) // 64


def bfs_scratch(size: int, stride: int, device) -> torch.Tensor:
    """The scratch of ``bfs_level`` for a BFS of ``size`` = B n keys: the
    tile sums, then ``size`` frontier entries' child masks, zeroed (each
    level leaves its masks zero again)."""
    tiles = -(-size // SCAN_TILE)
    return torch.zeros(tiles + size * mask_words(stride), dtype=torch.int64, device=device)


def bfs_level(
    bottom_up: bool,
    level: int,                   # the new level's depth
    queue: torch.Tensor,          # (B n,) int64 keys b * n + v, level by level
    epos: torch.Tensor,           # (B n,) int64 each queued key's discovering edge
    child: torch.Tensor,          # (B n + 1,) int64 each entry's first child's position
    qs: int,                      # the frontier is queue[qs, qs + F)
    F: int,
    rank: torch.Tensor,           # (B n,) int64 each discovered key's position in its level
    depth: torch.Tensor,          # (B n,) int32, -1 = undiscovered; the frontier's level - 1
    win: torch.Tensor,            # (B n,) int64, INF at every undiscovered key
    indptr: torch.Tensor,         # (n + 1,) int64
    nbr: torch.Tensor,            # (E,) int32
    rev_indptr: torch.Tensor,     # (n + 1,) int64
    rev_edge: torch.Tensor,       # (E,) int64 each in-edge's CSR id, reverse-CSR order
    rev_src: torch.Tensor,        # (E,) int32 its tail
    rev_slot: torch.Tensor,       # (E,) int32 its slot in the tail's adjacency
    deg: torch.Tensor,            # (n,) int64 out-degree << 32 | in-degree
    edge_ok: Optional[torch.Tensor],  # (E,) bool or None
    frontier_edges: int,          # the frontier's out-degree sum (picks the claim)
    scratch: torch.Tensor,        # int64, ``bfs_scratch(B n, stride)``
    info: torch.Tensor,           # (3,) int64 <- new size, its out- and in-degree sums
    n: int,
    stride: int,
) -> None:
    """One BFS level, written in place: the new level's keys and edges at
    ``queue[qs + F:]`` / ``epos[qs + F:]`` in (source, parent, slot) order,
    ``child[qs:qs + F]``, their ``depth`` and ``rank``, and ``info``."""
    if depth.device.type == "cpu":
        ref.bfs_level_ref(bottom_up, level, queue, epos, child, qs, F, rank, depth, win, indptr,
                          nbr, rev_indptr, rev_edge, rev_src, rev_slot, deg, edge_ok,
                          frontier_edges, scratch, info, n, stride)
        return
    dev = _check("flow_bfs_level", {
        "queue": (queue, "int64"), "epos": (epos, "int64"), "child": (child, "int64"),
        "rank": (rank, "int64"), "depth": (depth, "int32"), "win": (win, "int64"),
        "indptr": (indptr, "int64"), "nbr": (nbr, "int32"), "rev_indptr": (rev_indptr, "int64"),
        "rev_edge": (rev_edge, "int64"), "rev_src": (rev_src, "int32"),
        "rev_slot": (rev_slot, "int32"), "deg": (deg, "int64"), "edge_ok": (edge_ok, "bool"),
        "scratch": (scratch, "int64"), "info": (info, "int64")})
    size = depth.numel()
    if (size % n or any(t.numel() != size for t in (queue, epos, rank, win))
            or child.numel() != size + 1):
        raise ValueError(f"flow_bfs_level: queue, epos, rank, depth and win must hold B x n = "
                         f"{size} keys, child one more")
    if not 0 <= qs <= qs + F <= size:
        raise ValueError(f"flow_bfs_level: frontier [{qs}, {qs + F}) outside the queue")
    if scratch.numel() < -(-size // SCAN_TILE) + size * mask_words(stride) or info.numel() < 3:
        raise ValueError("flow_bfs_level: scratch or info too small (see bfs_scratch)")
    _launch("flow_bfs_level", dev, int(bool(bottom_up)), level, queue.data_ptr(), epos.data_ptr(),
            child.data_ptr(), qs, F, rank.data_ptr(), depth.data_ptr(), win.data_ptr(),
            indptr.data_ptr(), nbr.data_ptr(), rev_indptr.data_ptr(), rev_edge.data_ptr(),
            rev_src.data_ptr(), rev_slot.data_ptr(), deg.data_ptr(),
            None if edge_ok is None else edge_ok.data_ptr(), frontier_edges, scratch.data_ptr(),
            info.data_ptr(), size, n, stride)


def subtree_accumulate(
    queue: torch.Tensor,     # (B n,) int64, as bfs_level leaves it
    epos: torch.Tensor,      # (B n,) int64
    child: torch.Tensor,     # (B n + 1,) int64
    qs: int,                 # the level is queue[qs, qs + L)
    L: int,
    dest: torch.Tensor,      # (n,) int64 each vertex's destination weight
    cnt: torch.Tensor,       # int64 by queue position: the level below folded; this one written
    K: torch.Tensor,         # (E,) int64, added to
    n: int,
) -> None:
    """One level's fold: ``cnt[q] = dest[v] + Σ cnt[children of q]`` and
    ``K[epos[q]] += cnt[q]`` for every entry q of the level."""
    if K.device.type == "cpu":
        ref.subtree_accumulate_ref(queue, epos, child, qs, L, dest, cnt, K, n)
        return
    dev = _check("flow_subtree_accumulate", {
        "queue": (queue, "int64"), "epos": (epos, "int64"), "child": (child, "int64"),
        "dest": (dest, "int64"), "cnt": (cnt, "int64"), "K": (K, "int64")})
    if (epos.numel() != queue.numel() or child.numel() != queue.numel() + 1
            or not 0 <= qs <= qs + L <= min(queue.numel(), cnt.numel()) or dest.numel() != n):
        raise ValueError("flow_subtree_accumulate: queue, epos, child, cnt or dest of the wrong "
                         "size for the level")
    _launch("flow_subtree_accumulate", dev, queue.data_ptr(), epos.data_ptr(), child.data_ptr(),
            qs, L, dest.data_ptr(), cnt.data_ptr(), K.data_ptr(), n)


def orbit_gather(
    C: torch.Tensor,
    indptr: torch.Tensor,
    R: int,
    scale: int,
    step: int,
    m2: int,
) -> torch.Tensor:
    """-> K (R,) int64: the symmetry sweep's count table ``C`` (E,) summed
    over the translation group, for each of the ``R`` representative edges.

    The network has ``n = scale² m2`` vertices laid out ``((X scale + Y) m2
    + chip)`` and every translation by ``step`` is a slot-preserving
    automorphism of it (``CompiledNetwork.symmetry``); the representative
    edges are every CSR edge out of the block ``X, Y < step`` in CSR order,
    and ``K[i]`` belongs to the i-th of them.  Each edge lies in one orbit of
    ``(scale / step)²`` edges, so ``E == (scale / step)² R``, which is
    checked.  The kernel reads C once in CSR order (see ``csrc/flow.cu``);
    the plain version gathers the translated edges through
    ``ref.orbit_operands``."""
    per = scale // step if step >= 1 else 0
    n = indptr.numel() - 1
    if (step < 1 or scale % step or n != scale * scale * m2 or R < 0
            or C.numel() != per * per * R):
        raise ValueError(f"flow_orbit_gather: takes E = (scale / step)^2 R edges over scale^2 m2 "
                         f"vertices, got E = {C.numel()}, R = {R}, scale = {scale}, step = "
                         f"{step}, {n} vertices, m2 = {m2}")
    if C.device.type == "cpu":
        operands = ref.orbit_operands(indptr, scale, step, m2)
        return ref.orbit_gather_ref(C, indptr, *operands, scale, m2)
    dev = _check("flow_orbit_gather", {"C": (C, "int64"), "indptr": (indptr, "int64")})
    K = torch.zeros(R, dtype=torch.int64, device=dev)
    _launch("flow_orbit_gather", dev, C.data_ptr(), indptr.data_ptr(), R, scale, step, m2,
            K.data_ptr())
    return K


def ordered_fold(w_sorted: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """``w_sorted`` (L,) float64, the weights stably sorted by edge id;
    ``off`` (E + 1,) int64, each edge's run (``off[E] == L``) -> load (E,)
    float64."""
    if w_sorted.device.type == "cpu":
        return ref.ordered_fold_ref(w_sorted, off)
    dev = _check("flow_ordered_fold", {"w_sorted": (w_sorted, "float64"), "off": (off, "int64")})
    load = torch.empty(off.numel() - 1, dtype=torch.float64, device=dev)
    _launch("flow_ordered_fold", dev, w_sorted.data_ptr(), w_sorted.numel(), off.data_ptr(),
            load.numel(), load.data_ptr())
    return load
