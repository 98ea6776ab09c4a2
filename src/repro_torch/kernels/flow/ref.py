"""Plain PyTorch versions of the flow-level simulator's kernels
(``csrc/flow.cu``), on tensors of any device.  The wrappers in ``flow.py``
run them on CPU tensors; ``chip_smoke.py`` holds the kernels against them on
the card.  Each computes the same function as its kernel, with the same
arguments (``edge_ok`` ``None`` or a bool tensor):

* ``bfs_level_ref``: ``win`` of one BFS level, the least ``rank(parent) *
  stride + slot`` over the eligible edges into each undiscovered key, by
  ``scatter_reduce(..., "amin")`` (a minimum, so no order is needed:
  ``index_put_`` with repeated indices would promise no winner);
  ``bottom_up`` enumerates the undiscovered keys' in-edges instead of the
  frontier's out-edges, the same candidates that reach a minimum;
* ``subtree_accumulate_ref``: ``index_add_`` of one depth's counts into
  their parents' counts and their parent edges' totals (int64: exact in
  any order);
* ``orbit_gather_ref``: the group sum of ``C`` over translated edges, a
  chunk of the group at a time, in int64;
* ``ordered_fold_ref``: each edge's run of the stably sorted weights
  summed strictly left to right from 0.0, one column of the runs at a
  time (``torch.cumsum`` and ``index_add_`` promise no order).
"""

from __future__ import annotations

from typing import Optional

import torch

INF = torch.iinfo(torch.int64).max


def _ranges(starts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Concatenated ``arange(s, s + c)`` for every (s, c)."""
    total = int(counts.sum())
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=starts.device)
    prev = torch.cumsum(counts, 0) - counts
    return torch.arange(total, dtype=torch.int64, device=starts.device) + torch.repeat_interleave(
        starts - prev, counts)


def bfs_level_ref(
    bottom_up: bool,
    fkeys: torch.Tensor,
    rank: torch.Tensor,
    depth: torch.Tensor,
    indptr: torch.Tensor,
    nbr: torch.Tensor,
    rev_indptr: torch.Tensor,
    rev_edge: torch.Tensor,
    edge_src: torch.Tensor,
    edge_slot: torch.Tensor,
    edge_ok: Optional[torch.Tensor],
    win: torch.Tensor,
    n: int,
    stride: int,
) -> None:
    win.fill_(INF)
    if bottom_up:
        und = torch.nonzero(depth == -1).flatten()
        v = und % n
        deg = rev_indptr[v + 1] - rev_indptr[v]
        fe = rev_edge[_ranges(rev_indptr[v], deg)]
        heads = torch.repeat_interleave(und, deg)
        r = rank[heads - heads % n + edge_src[fe].long()]
        ok = r != INF
        if edge_ok is not None:
            ok &= edge_ok[fe]
        heads, cand = heads[ok], r[ok] * stride + edge_slot[fe[ok]]
    else:
        u = fkeys % n
        deg = indptr[u + 1] - indptr[u]
        e = _ranges(indptr[u], deg)
        tails = torch.repeat_interleave(fkeys, deg)
        heads = tails - tails % n + nbr[e].long()
        ok = depth[heads] == -1
        if edge_ok is not None:
            ok &= edge_ok[e]
        slot = e - torch.repeat_interleave(indptr[u], deg)
        heads, cand = heads[ok], rank[tails[ok]] * stride + slot[ok]
    win.scatter_reduce_(0, heads, cand, "amin")


def subtree_accumulate_ref(keys, epos, edge_src, cnt, K, n: int) -> None:
    w = cnt[keys]
    K.index_add_(0, epos, w)
    cnt.index_add_(0, keys - keys % n + edge_src[epos].long(), w)


G_CHUNK = 2048  # group elements gathered at once, as the reference's loop


def orbit_gather_ref(C, indptr, re_u, re_slot, sx, sy, scale: int, m2: int) -> torch.Tensor:
    node, chip = re_u // m2, re_u % m2
    X, Y = node // scale, node % scale
    K = torch.zeros(re_u.numel(), dtype=torch.int64, device=C.device)
    for lo in range(0, sx.numel(), G_CHUNK):
        gx = sx[lo:lo + G_CHUNK, None]
        gy = sy[lo:lo + G_CHUNK, None]
        u2 = (((X[None, :] + gx) % scale) * scale + (Y[None, :] + gy) % scale) * m2 + chip[None, :]
        K += C[indptr[u2] + re_slot[None, :]].sum(0)
    return K


def ordered_fold_ref(w_sorted: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    counts = off[1:] - off[:-1]
    load = torch.zeros(counts.numel(), dtype=torch.float64, device=w_sorted.device)
    for j in range(int(counts.max()) if counts.numel() else 0):
        live = counts > j
        load = torch.where(live, load + w_sorted[torch.where(live, off[:-1] + j, 0)], load)
    return load
