"""Plain PyTorch versions of the flow-level simulator's kernels
(``csrc/flow.cu``), on tensors of any device.  The wrappers in ``flow.py``
run them on CPU tensors; ``chip_smoke.py`` holds the kernels against them on
the card.  Each computes the same function as its kernel, with the same
arguments (``edge_ok`` ``None`` or a bool tensor):

* ``bfs_level_ref``: one whole BFS level.  Each undiscovered key takes the
  least ``rank(parent) * stride + slot`` over its eligible in-edges, by
  ``scatter_reduce(..., "amin")`` (a minimum, so no order is needed:
  ``index_put_`` with repeated indices would promise no winner);
  ``bottom_up`` enumerates the undiscovered keys' in-edges instead of the
  frontier's out-edges (the frontier is the keys of depth ``level - 1``),
  the same candidates that reach a minimum.  The winners sorted by that
  key are the new level in (source, parent, slot) order; then the queue,
  ``epos``, ``depth``, ``rank``, the child offsets (``bincount``,
  ``cumsum``), ``info`` and, top-down, ``win`` at the winners, as the
  kernel leaves them (``scratch`` and ``frontier_edges`` are the kernel's
  alone);
* ``subtree_accumulate_ref``: one level's counts, each entry's destination
  weight plus its children's counts (a difference of a ``cumsum`` over the
  level below: int64, exact), added to its parent edge's total by
  ``index_add_``;
* ``orbit_gather_ref``: the group sum of ``C`` over translated edges, a
  chunk of the group at a time, in int64, through the index tensors
  ``orbit_operands`` builds (the representative edges, the group);
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
    level: int,
    queue: torch.Tensor,
    epos: torch.Tensor,
    child: torch.Tensor,
    qs: int,
    F: int,
    rank: torch.Tensor,
    depth: torch.Tensor,
    win: torch.Tensor,
    indptr: torch.Tensor,
    nbr: torch.Tensor,
    rev_indptr: torch.Tensor,
    rev_edge: torch.Tensor,
    rev_src: torch.Tensor,
    rev_slot: torch.Tensor,
    deg: torch.Tensor,
    edge_ok: Optional[torch.Tensor],
    frontier_edges: int,
    scratch: torch.Tensor,
    info: torch.Tensor,
    n: int,
    stride: int,
) -> None:
    size = depth.numel()
    fkeys = queue[qs:qs + F]
    if bottom_up:
        und = torch.nonzero(depth == -1).flatten()
        v = und % n
        ins = rev_indptr[v + 1] - rev_indptr[v]
        j = _ranges(rev_indptr[v], ins)
        heads = torch.repeat_interleave(und, ins)
        tails = heads - heads % n + rev_src[j].long()
        ok = depth[tails] == level - 1   # the frontier
        if edge_ok is not None:
            ok &= edge_ok[rev_edge[j]]
        heads, cand = heads[ok], rank[tails[ok]] * stride + rev_slot[j[ok]].long()
    else:
        u = fkeys % n
        outs = indptr[u + 1] - indptr[u]
        e = _ranges(indptr[u], outs)
        tails = torch.repeat_interleave(fkeys, outs)
        heads = tails - tails % n + nbr[e].long()
        ok = depth[heads] == -1
        if edge_ok is not None:
            ok &= edge_ok[e]
        pos = torch.repeat_interleave(torch.arange(F, device=queue.device), outs)
        slot = e - torch.repeat_interleave(indptr[u], outs)
        heads, cand = heads[ok], pos[ok] * stride + slot[ok]
    best = torch.full((size,), INF, dtype=torch.int64, device=queue.device)
    best.scatter_reduce_(0, heads, cand, "amin")
    new = torch.nonzero(best != INF).flatten()
    wk = best[new]
    order = torch.argsort(wk)  # distinct: a (parent entry, slot) pair names one key
    new, wk = new[order], wk[order]
    parent = wk // stride
    Fn, out = new.numel(), qs + F
    queue[out:out + Fn] = new
    epos[out:out + Fn] = indptr[fkeys[parent] % n] + wk % stride
    if not bottom_up:
        win[new] = wk
    depth[new] = level
    rank[new] = torch.arange(Fn, dtype=torch.int64, device=queue.device)
    counts = torch.bincount(parent, minlength=F)
    child[qs:qs + F] = out + torch.cumsum(counts, 0) - counts
    dv = deg[new % n]
    info[0] = Fn
    info[1] = (dv >> 32).sum()
    info[2] = (dv & 0xFFFFFFFF).sum()


def subtree_accumulate_ref(queue, epos, child, qs: int, L: int, dest, cnt, K, n: int) -> None:
    first, last = child[qs:qs + L], child[qs + 1:qs + L + 1]
    lo = int(child[qs]) if L else 0
    hi = int(child[qs + L]) if L else 0
    pre = torch.zeros(hi - lo + 1, dtype=torch.int64, device=cnt.device)
    torch.cumsum(cnt[lo:hi], 0, out=pre[1:])
    c = dest[queue[qs:qs + L] % n] + pre[last - lo] - pre[first - lo]
    cnt[qs:qs + L] = c
    K.index_add_(0, epos[qs:qs + L], c)


G_CHUNK = 2048  # group elements gathered at once, as the reference's loop


def orbit_operands(indptr, scale: int, step: int, m2: int):
    """``(re_u, re_slot, sx, sy)``, the gather's index tensors: the source
    and CSR slot of every edge out of the block ``X, Y < step`` in CSR order,
    and the translation group's shifts (multiples of ``step``)."""
    dev = indptr.device
    blk = torch.arange(step, dtype=torch.int64, device=dev)
    nodes = (blk[:, None] * scale + blk[None, :]).reshape(-1)
    reps = (nodes[:, None] * m2 + torch.arange(m2, device=dev)[None, :]).reshape(-1)
    deg = indptr[reps + 1] - indptr[reps]
    re_u = torch.repeat_interleave(reps, deg)
    first = torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
    re_slot = torch.arange(re_u.numel(), device=dev) - first
    shifts = torch.arange(0, scale, step, dtype=torch.int64, device=dev)
    sx, sy = torch.meshgrid(shifts, shifts, indexing="ij")
    return re_u, re_slot, sx.reshape(-1), sy.reshape(-1)


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
