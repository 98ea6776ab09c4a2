"""Placement policies: fit a rows x cols rectangular job onto the free
nodes of the RailX grid (paper §6.6 / Figure 20).

The port's own copy of ``repro/cluster/placement.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

The OCS constraint is per-job rectangularity over *subsets* of rows and
columns — rows/cols need not be contiguous because circuit switching
permutes node order freely.  A placement therefore is a ``JobAllocation``
(row subset x column subset) fully contained in the free set.

Policies:

* ``first_fit``    — first rectangle found scanning rows by free count;
* ``best_fit``     — among candidate rectangles, minimize the
                     fragmentation score (free cells stranded in the
                     chosen rows/columns that the job does not use);
* ``rail_aware``   — reuse the Figure-20 greedy rail packing
                     (``availability.allocate_multi_jobs_masks``) to
                     propose maximal sub-grids, then trim the first
                     proposal that covers the request.

All three operate on the scheduler's ``OccupancyIndex`` — per-row integer
bitmasks where intersection is ``&`` and cardinality is ``int.bit_count``
— instead of frozenset algebra over an O(n^2) coordinate set.  The
original set-based implementations are kept below as ``*_ref``; the
property tests in the reference's ``tests/test_occupancy.py`` assert the
bitmask policies return *identical* allocations on randomized grids, so
swapping the representation cannot change scheduling decisions.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..core.availability import (
    JobAllocation,
    allocate_multi_jobs_masks,
    allocate_multi_jobs_ref,
)
from .occupancy import OccupancyIndex, iter_bits, lowest_bits, mask_of

Coord = Tuple[int, int]
PlacementPolicy = Callable[[int, OccupancyIndex, int, int], Optional[JobAllocation]]


# ---------------------------------------------------------------------------
# Bitmask policies (the registry entries the scheduler uses)
# ---------------------------------------------------------------------------


def _rows_by_free(n: int, occ: OccupancyIndex) -> List[Tuple[int, int]]:
    """(row, free-column-mask) sorted by free count desc, row asc."""
    per_row = []
    for r in range(n):
        mask = occ.free_row(r)
        if mask:
            per_row.append((r, mask))
    per_row.sort(key=lambda rm: (-rm[1].bit_count(), rm[0]))
    return per_row


def _grow_from_seed(
    per_row: Sequence[Tuple[int, int]],
    seed_idx: int,
    rows_req: int,
    cols_req: int,
) -> Optional[JobAllocation]:
    """Greedy row accretion keeping the common free-column mask >= cols_req."""
    seed_row, seed_cols = per_row[seed_idx]
    if seed_cols.bit_count() < cols_req:
        return None
    rows = [seed_row]
    cols = seed_cols
    for i, (r, rcols) in enumerate(per_row):
        if len(rows) == rows_req:
            break
        if i == seed_idx:
            continue
        new_cols = cols & rcols
        if new_cols.bit_count() >= cols_req:
            rows.append(r)
            cols = new_cols
    if len(rows) < rows_req:
        return None
    return JobAllocation(tuple(sorted(rows)), lowest_bits(cols, cols_req))


def first_fit(
    n: int, occ: OccupancyIndex, rows_req: int, cols_req: int
) -> Optional[JobAllocation]:
    per_row = _rows_by_free(n, occ)
    for seed in range(len(per_row)):
        alloc = _grow_from_seed(per_row, seed, rows_req, cols_req)
        if alloc is not None:
            return alloc
    return None


def _fragmentation_score(
    per_row: Sequence[Tuple[int, int]], alloc: JobAllocation
) -> int:
    """Free cells in the allocation's rows and columns that the job leaves
    stranded — a proxy for how much future rectangular capacity this
    placement destroys (rows/cols it touches can no longer host a clean
    rectangle through those lines)."""
    rows = set(alloc.rows)
    cmask = mask_of(alloc.cols)
    stranded = 0
    for r, free_mask in per_row:
        if r in rows:
            stranded += (free_mask & ~cmask).bit_count()
        else:
            stranded += (free_mask & cmask).bit_count()
    return stranded


def best_fit(
    n: int, occ: OccupancyIndex, rows_req: int, cols_req: int
) -> Optional[JobAllocation]:
    per_row = _rows_by_free(n, occ)
    best: Optional[JobAllocation] = None
    best_score = None
    for seed in range(len(per_row)):
        alloc = _grow_from_seed(per_row, seed, rows_req, cols_req)
        if alloc is None:
            continue
        score = _fragmentation_score(per_row, alloc)
        if best_score is None or score < best_score:
            best, best_score = alloc, score
    return best


def gang_scored_fit(
    n: int,
    occ: OccupancyIndex,
    rows_req: int,
    cols_req: int,
    row_weight: Dict[int, int],
    col_weight: Dict[int, int],
) -> Optional[JobAllocation]:
    """Topology-aware gang placement: prefer rectangles sharing OCS
    switch groups with circuits already programmed on the fabric.

    A job's circuits live on the switches of its rows (X rails) and
    columns (Y rails); ``row_weight``/``col_weight`` count programmed
    switch keys per line (live or lazily-retained — see the scheduler's
    orphan tracking).  Maximizing the summed weight steers repeat shapes
    back onto the lines whose switches already hold their rings, so the
    install diff degenerates to few/no mirror strokes.  Ties break on the
    ``best_fit`` fragmentation score, then on seed order — fully
    deterministic.
    """
    per_row = _rows_by_free(n, occ)
    best: Optional[JobAllocation] = None
    best_key: Optional[Tuple[int, int]] = None
    for seed in range(len(per_row)):
        alloc = _grow_from_seed(per_row, seed, rows_req, cols_req)
        if alloc is None:
            continue
        affinity = sum(row_weight.get(r, 0) for r in alloc.rows) + sum(
            col_weight.get(c, 0) for c in alloc.cols
        )
        key = (-affinity, _fragmentation_score(per_row, alloc))
        if best_key is None or key < best_key:
            best, best_key = alloc, key
    return best


def rail_aware(
    n: int, occ: OccupancyIndex, rows_req: int, cols_req: int
) -> Optional[JobAllocation]:
    """Propose maximal healthy sub-grids with the Figure-20 greedy packer
    (treating non-free nodes as faults), then trim the first that fits.

    Feeds the index's free-row bitmasks straight into the packer's
    bitmask core — no O(n²) occupied-coordinate materialization and no
    frozenset algebra anywhere on the proposal path."""
    masks = [occ.free_row(r) for r in range(n)]
    for prop in allocate_multi_jobs_masks(n, masks, max_jobs=8):
        if len(prop.rows) >= rows_req and len(prop.cols) >= cols_req:
            return JobAllocation(prop.rows[:rows_req], prop.cols[:cols_req])
    return None


def partial_refit(
    n: int,
    occ: OccupancyIndex,
    alloc: JobAllocation,
    bad_rows: FrozenSet[int],
    bad_cols: FrozenSet[int],
) -> Optional[JobAllocation]:
    """Minimal sub-allocation diff for the partial-migration rung: keep
    every line of ``alloc`` not named in ``bad_rows``/``bad_cols`` and
    substitute free lines for the bad ones, preserving the rectangle
    shape.

    The occupancy index still shows the job occupying ``alloc`` — kept
    lines are valid precisely because the job's own cells sit on them.
    Substitutes are chosen greedily and deterministically: rows ascending
    among rows free across every kept column, then columns ascending
    among columns free across every row of the new rectangle.  Bad lines
    are never reused (their switches are the dead hardware being
    escaped).  Returns None when no same-shape substitution exists —
    the scheduler then falls through to a full migrate."""
    kept_rows = [r for r in alloc.rows if r not in bad_rows]
    kept_cols = [c for c in alloc.cols if c not in bad_cols]
    need_rows = len(alloc.rows) - len(kept_rows)
    need_cols = len(alloc.cols) - len(kept_cols)
    if need_rows == 0 and need_cols == 0:
        return None
    old_rows = set(alloc.rows)
    old_cols = set(alloc.cols)
    kept_cmask = mask_of(tuple(kept_cols))
    new_rows: List[int] = []
    for r in range(n):
        if len(new_rows) == need_rows:
            break
        if r in old_rows:
            continue
        if occ.free_row(r) & kept_cmask == kept_cmask:
            new_rows.append(r)
    if len(new_rows) < need_rows:
        return None
    rows2 = sorted(kept_rows + new_rows)
    common = (1 << n) - 1
    for r in rows2:
        common &= occ.free_row(r)
    new_cols: List[int] = []
    for c in iter_bits(common):
        if len(new_cols) == need_cols:
            break
        if c in old_cols:
            continue
        new_cols.append(c)
    if len(new_cols) < need_cols:
        return None
    cols2 = sorted(kept_cols + new_cols)
    return JobAllocation(tuple(rows2), tuple(cols2))


# ---------------------------------------------------------------------------
# Reference (seed) set-based implementations — used by the equivalence
# property tests; NOT registered as policies.
# ---------------------------------------------------------------------------


def _rows_by_free_ref(n: int, free: Set[Coord]) -> List[Tuple[int, FrozenSet[int]]]:
    per_row = []
    for r in range(n):
        cols = frozenset(c for c in range(n) if (r, c) in free)
        if cols:
            per_row.append((r, cols))
    per_row.sort(key=lambda rc: (-len(rc[1]), rc[0]))
    return per_row


def _grow_from_seed_ref(
    per_row: Sequence[Tuple[int, FrozenSet[int]]],
    seed_idx: int,
    rows_req: int,
    cols_req: int,
) -> Optional[JobAllocation]:
    seed_row, seed_cols = per_row[seed_idx]
    if len(seed_cols) < cols_req:
        return None
    rows = [seed_row]
    cols = seed_cols
    for i, (r, rcols) in enumerate(per_row):
        if len(rows) == rows_req:
            break
        if i == seed_idx:
            continue
        new_cols = cols & rcols
        if len(new_cols) >= cols_req:
            rows.append(r)
            cols = new_cols
    if len(rows) < rows_req:
        return None
    chosen_cols = tuple(sorted(cols)[:cols_req])
    return JobAllocation(tuple(sorted(rows)), chosen_cols)


def first_fit_ref(
    n: int, free: Set[Coord], rows_req: int, cols_req: int
) -> Optional[JobAllocation]:
    per_row = _rows_by_free_ref(n, free)
    for seed in range(len(per_row)):
        alloc = _grow_from_seed_ref(per_row, seed, rows_req, cols_req)
        if alloc is not None:
            return alloc
    return None


def _fragmentation_score_ref(
    n: int, free: Set[Coord], alloc: JobAllocation
) -> int:
    rows, cols = set(alloc.rows), set(alloc.cols)
    stranded = 0
    for (r, c) in free:
        in_rows, in_cols = r in rows, c in cols
        if in_rows != in_cols:  # crossed by the job's rows xor cols
            stranded += 1
    return stranded


def best_fit_ref(
    n: int, free: Set[Coord], rows_req: int, cols_req: int
) -> Optional[JobAllocation]:
    per_row = _rows_by_free_ref(n, free)
    best: Optional[JobAllocation] = None
    best_score = None
    for seed in range(len(per_row)):
        alloc = _grow_from_seed_ref(per_row, seed, rows_req, cols_req)
        if alloc is None:
            continue
        score = _fragmentation_score_ref(n, free, alloc)
        if best_score is None or score < best_score:
            best, best_score = alloc, score
    return best


def rail_aware_ref(
    n: int, free: Set[Coord], rows_req: int, cols_req: int
) -> Optional[JobAllocation]:
    occupied = [(r, c) for r in range(n) for c in range(n) if (r, c) not in free]
    for prop in allocate_multi_jobs_ref(n, occupied, max_jobs=8):
        if len(prop.rows) >= rows_req and len(prop.cols) >= cols_req:
            return JobAllocation(prop.rows[:rows_req], prop.cols[:cols_req])
    return None


POLICIES: Dict[str, PlacementPolicy] = {
    "first_fit": first_fit,
    "best_fit": best_fit,
    "rail_aware": rail_aware,
}

REFERENCE_POLICIES: Dict[str, Callable[[int, Set[Coord], int, int], Optional[JobAllocation]]] = {
    "first_fit": first_fit_ref,
    "best_fit": best_fit_ref,
    "rail_aware": rail_aware_ref,
}


def get_policy(name: str) -> PlacementPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown placement policy {name!r}; have {list(POLICIES)}")
