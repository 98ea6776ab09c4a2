"""Reliability / availability on the faulted RailX grid (paper §6.6, §A.5).

The port's own copy of ``repro/core/availability.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

A failed node disconnects its row and column for a *single* rectangular
allocation (the OCS can bypass a node only by excluding its whole row or
column from the rings).  ``max_single_allocation`` implements the paper's
Algorithm 2; ``allocate_multi_jobs`` implements the MLaaS packing of
Figure 20; ``availability_curve`` reproduces Figure 17.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

Coord = Tuple[int, int]


def _classify(n: int, faults: Sequence[Coord]) -> Tuple[List[Coord], List[Coord]]:
    """Split faults into isolated (unique row AND column) and non-isolated."""
    rows: Dict[int, int] = {}
    cols: Dict[int, int] = {}
    for r, c in faults:
        rows[r] = rows.get(r, 0) + 1
        cols[c] = cols.get(c, 0) + 1
    isolated, clustered = [], []
    for r, c in faults:
        if rows[r] == 1 and cols[c] == 1:
            isolated.append((r, c))
        else:
            clustered.append((r, c))
    return isolated, clustered


def max_single_allocation(n: int, faults: Sequence[Coord]) -> int:
    """Algorithm 2: max available single-job allocation size (nodes) in an
    n x n grid with faulted nodes.

    Every fault must have its row or column disabled.  Isolated faults are
    interchangeable (disable row or column freely), so we only enumerate
    the 2^|C| choices for non-isolated faults and split the |I| isolated
    faults r'/c' to balance the remaining rectangle.
    """
    faults = list(dict.fromkeys(faults))
    if not faults:
        return n * n
    isolated, clustered = _classify(n, faults)
    if not clustered:
        ni = len(isolated)
        r = ni // 2
        c = ni - r
        # ceil/floor split per the paper
        return (n - max(r, c)) * (n - min(r, c))

    best = 0
    for choice in itertools.product((0, 1), repeat=len(clustered)):
        dis_rows: Set[int] = set()
        dis_cols: Set[int] = set()
        for (r, c), bit in zip(clustered, choice):
            if bit == 0:
                dis_rows.add(r)
            else:
                dis_cols.add(c)
        ri = len(dis_rows)
        ci = len(dis_cols)
        # isolated faults whose row/col is already disabled are free
        rem = [f for f in isolated if f[0] not in dis_rows and f[1] not in dis_cols]
        ni = len(rem)
        # split remaining isolated faults r' rows + c' cols to balance
        local_best = 0
        for rp in range(ni + 1):
            cp = ni - rp
            avail = max(0, n - ri - rp) * max(0, n - ci - cp)
            local_best = max(local_best, avail)
        best = max(best, local_best)
    return best


def worst_case_allocation(n: int, num_faults: int) -> int:
    """Paper: 2a faults spread over distinct rows+columns -> (n-a)^2-ish;
    generally faults all isolated and maximally spread."""
    r = num_faults // 2
    c = num_faults - r
    return max(0, n - max(r, c)) * max(0, n - min(r, c))


def best_case_allocation(n: int, num_faults: int) -> int:
    """All faults share one row (or column): lose a single row."""
    if num_faults == 0:
        return n * n
    return n * (n - 1)


def availability_curve(
    n: int,
    failure_rates: Sequence[float],
    samples: int = 100,
    seed: int = 0,
) -> Dict[float, float]:
    """Figure 17(b): mean fraction of chips usable by a single job, sampling
    ``samples`` random fault sets per failure rate."""
    rng = random.Random(seed)
    out: Dict[float, float] = {}
    total = n * n
    for rate in failure_rates:
        acc = 0.0
        for _ in range(samples):
            faults = []
            for r in range(n):
                for c in range(n):
                    if rng.random() < rate:
                        faults.append((r, c))
            # Algorithm 2 is exponential in clustered faults; cap for speed
            _, clustered = _classify(n, faults)
            if len(clustered) > 18:
                # extremely high failure rates: fall back to the worst-case
                # bound (paper's fast path only targets sparse faults)
                acc += worst_case_allocation(n, len(faults)) / total
            else:
                acc += max_single_allocation(n, faults) / total
        out[rate] = acc / samples
    return out


# ---------------------------------------------------------------------------
# MLaaS multi-job allocation (§A.5, Figure 20)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JobAllocation:
    rows: Tuple[int, ...]
    cols: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.rows) * len(self.cols)


# -- column-bitmask helpers (shared with cluster.occupancy / placement) ----


def iter_bits(mask: int):
    """Yield the set bit positions of ``mask`` in ascending order."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


def lowest_bits(mask: int, k: int) -> Tuple[int, ...]:
    """The ``k`` lowest set bit positions of ``mask`` (== sorted(bits)[:k])."""
    out: List[int] = []
    for b in iter_bits(mask):
        if len(out) == k:
            break
        out.append(b)
    return tuple(out)


def mask_of(cols: Sequence[int]) -> int:
    m = 0
    for c in cols:
        m |= 1 << c
    return m


def allocate_multi_jobs_masks(
    n: int, healthy_masks: Sequence[int], max_jobs: int = 8
) -> List[JobAllocation]:
    """Bitmask core of the Figure-20 greedy packer: ``healthy_masks[r]``
    is the bitmask of available columns in row ``r``.  Column-set algebra
    is ``&``/``bit_count`` instead of frozenset intersections; iteration
    order and every comparison mirror the set-based reference
    (``allocate_multi_jobs_ref``) exactly, so the proposals — and any
    scheduling decision built on them — are identical (property-tested in
    the reference's ``tests/test_occupancy.py``)."""
    masks = list(healthy_masks)
    jobs: List[JobAllocation] = []
    while any(masks) and len(jobs) < max_jobs:
        best: JobAllocation | None = None
        rows_by_count = sorted(range(n), key=lambda r: -masks[r].bit_count())
        for r0 in rows_by_count[: max(4, n // 4)]:
            cols0 = masks[r0]
            if not cols0:
                continue
            rows = [r0]
            cols = cols0
            cand = JobAllocation((r0,), tuple(iter_bits(cols)))
            if best is None or cand.size > best.size:
                best = cand
            for r in rows_by_count:
                if r in rows:
                    continue
                new_cols = cols & masks[r]
                if new_cols.bit_count() * (len(rows) + 1) >= (
                    cols.bit_count() * len(rows)
                ):
                    rows.append(r)
                    cols = new_cols
                    cand = JobAllocation(
                        tuple(sorted(rows)), tuple(iter_bits(cols))
                    )
                    if cand.size > best.size:
                        best = cand
        if best is None or best.size == 0:
            break
        jobs.append(best)
        cmask = mask_of(best.cols)
        for r in best.rows:
            masks[r] &= ~cmask
    return jobs


def allocate_multi_jobs(
    n: int, faults: Sequence[Coord], max_jobs: int = 8
) -> List[JobAllocation]:
    """Greedy MLaaS packing: repeatedly allocate the largest healthy
    row x column sub-grid among the *unassigned* healthy nodes.

    The OCS constraint is per-job rectangularity over a subset of rows and
    columns (rows/cols need not be contiguous — circuit switching permutes
    freely, Figure 20).  Thin wrapper over the bitmask core."""
    full = (1 << n) - 1
    masks = [full] * n
    for r, c in faults:  # mask-clear is idempotent; no dedup needed
        masks[r] &= ~(1 << c)
    return allocate_multi_jobs_masks(n, masks, max_jobs=max_jobs)


def allocate_multi_jobs_ref(
    n: int, faults: Sequence[Coord], max_jobs: int = 8
) -> List[JobAllocation]:
    """The seed frozenset implementation, kept as the equivalence-test
    reference for ``allocate_multi_jobs_masks``."""
    healthy = {
        (r, c) for r in range(n) for c in range(n) if (r, c) not in set(faults)
    }
    jobs: List[JobAllocation] = []
    while healthy and len(jobs) < max_jobs:
        # greedy: order rows by healthy count, grow best rectangle
        best: JobAllocation | None = None
        rows_by_count = sorted(
            range(n), key=lambda r: -sum(1 for c in range(n) if (r, c) in healthy)
        )
        for r0 in rows_by_count[: max(4, n // 4)]:
            cols0 = frozenset(c for c in range(n) if (r0, c) in healthy)
            if not cols0:
                continue
            rows = [r0]
            cols = cols0
            cand = JobAllocation(tuple(rows), tuple(sorted(cols)))
            if best is None or cand.size > best.size:
                best = cand
            for r in rows_by_count:
                if r in rows:
                    continue
                new_cols = cols & frozenset(
                    c for c in range(n) if (r, c) in healthy
                )
                if len(new_cols) * (len(rows) + 1) >= len(cols) * len(rows):
                    rows.append(r)
                    cols = new_cols
                    cand = JobAllocation(tuple(sorted(rows)), tuple(sorted(cols)))
                    if cand.size > best.size:
                        best = cand
        if best is None or best.size == 0:
            break
        jobs.append(best)
        for r in best.rows:
            for c in best.cols:
                healthy.discard((r, c))
    return jobs


def utilization(n: int, faults: Sequence[Coord], jobs: Sequence[JobAllocation]) -> float:
    healthy = n * n - len(set(faults))
    used = sum(j.size for j in jobs)
    return used / healthy if healthy else 0.0
