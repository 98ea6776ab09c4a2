"""Incremental occupancy index for the cluster scheduler's node grid.

The port's own copy of ``repro/cluster/occupancy.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

``ClusterScheduler.free_nodes()`` used to rebuild an O(n^2) coordinate
set on every placement attempt; at 64x64 that one helper dominated the
event loop (see BENCH_cluster.json history).  ``OccupancyIndex`` keeps
the same information as two per-row integer bitmasks — occupied columns
and faulted columns — updated in O(footprint) on place / evict / fault /
recover, so the free set for a row is a single ``full & ~(occ | fault)``
expression and popcounts replace set cardinalities.

Invariants (checked by the property tests in the reference's
``tests/test_occupancy.py``):

* a cell is free iff it is neither occupied nor faulted; ``free_count``
  always equals the popcount of all free-row masks;
* occupied and faulted are tracked independently, so a node may be both
  (a fault inside a running job's rectangle, between the fault event and
  the eviction) without corrupting the index;
* ``version`` increments on every mutation.  Two observations with the
  same version saw the *identical* free set, which is what lets the
  scheduler skip re-running a deterministic placement policy that
  already failed (the backlog watermark gate).
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

# canonical bit-twiddling helpers live next to the mask-based Figure-20
# packer in core.availability; re-exported here for the placement policies
from ..core.availability import iter_bits, lowest_bits, mask_of  # noqa: F401

Coord = Tuple[int, int]


class OccupancyIndex:
    """Per-row bitmask view of an ``n x n`` node grid."""

    __slots__ = ("n", "full", "_occ", "_fault", "version", "free_count")

    def __init__(self, n: int):
        self.n = n
        self.full = (1 << n) - 1
        self._occ: List[int] = [0] * n
        self._fault: List[int] = [0] * n
        self.version = 0
        self.free_count = n * n

    # -- queries ------------------------------------------------------------

    def free_row(self, r: int) -> int:
        """Bitmask of free columns in row ``r``."""
        return self.full & ~(self._occ[r] | self._fault[r])

    def is_free(self, node: Coord) -> bool:
        r, c = node
        return bool(self.free_row(r) & (1 << c))

    def free_set(self) -> Set[Coord]:
        """Materialize the free set (compatibility / test helper; O(n^2))."""
        out: Set[Coord] = set()
        for r in range(self.n):
            for c in iter_bits(self.free_row(r)):
                out.add((r, c))
        return out

    def occupied_list(self) -> List[Coord]:
        """Non-free cells in row-major order (inspection/test helper; the
        ``rail_aware`` policy feeds ``free_row`` masks straight to the
        bitmask packer and never materializes this list)."""
        out: List[Coord] = []
        for r in range(self.n):
            unfree = self.full & ~self.free_row(r)
            for c in iter_bits(unfree):
                out.append((r, c))
        return out

    def can_fit(self, rows_req: int, cols_req: int) -> bool:
        """Necessary condition for any ``rows_req x cols_req`` rectangle:
        at least ``rows_req`` rows each holding >= ``cols_req`` free cells.
        O(n); a sound pre-filter for every placement policy."""
        if rows_req * cols_req > self.free_count:
            return False
        have = 0
        for r in range(self.n):
            if self.free_row(r).bit_count() >= cols_req:
                have += 1
                if have >= rows_req:
                    return True
        return False

    # -- mutations (all O(footprint), all bump ``version``) -----------------

    def occupy(self, rows: Sequence[int], cols: Sequence[int]) -> None:
        cmask = mask_of(cols)
        for r in rows:
            newly = cmask & ~self._occ[r] & ~self._fault[r]
            self.free_count -= newly.bit_count()
            self._occ[r] |= cmask
        self.version += 1

    def release(self, rows: Sequence[int], cols: Sequence[int]) -> None:
        cmask = mask_of(cols)
        for r in rows:
            newly = cmask & self._occ[r] & ~self._fault[r]
            self.free_count += newly.bit_count()
            self._occ[r] &= ~cmask
        self.version += 1

    def fault(self, node: Coord) -> None:
        r, c = node
        bit = 1 << c
        if not self._fault[r] & bit:
            if not self._occ[r] & bit:
                self.free_count -= 1
            self._fault[r] |= bit
        self.version += 1

    def recover(self, node: Coord) -> None:
        r, c = node
        bit = 1 << c
        if self._fault[r] & bit:
            self._fault[r] &= ~bit
            if not self._occ[r] & bit:
                self.free_count += 1
        self.version += 1

    def touch(self) -> None:
        """Bump ``version`` without changing the free set.

        Placement outcomes depend on more than node occupancy once
        switch/link fault sets enter the picture (degraded placement can
        fail on a fabric the free set says is fine); the scheduler calls
        this on every fabric-health change so the backlog watermark's
        "same version => same result" contract stays sound.
        """
        self.version += 1

    # -- construction helpers ----------------------------------------------

    def clone(self) -> "OccupancyIndex":
        """Independent copy (O(n)); used to trial hypothetical placements
        — preemption victim selection and re-expansion probe the
        deterministic policies on a clone before touching real state."""
        idx = OccupancyIndex(self.n)
        idx._occ = list(self._occ)
        idx._fault = list(self._fault)
        idx.version = self.version
        idx.free_count = self.free_count
        return idx

    @classmethod
    def from_free_set(cls, n: int, free: Set[Coord]) -> "OccupancyIndex":
        """Index whose free set equals ``free`` (everything else occupied)."""
        idx = cls(n)
        for r in range(n):
            miss = idx.full & ~mask_of([c for c in range(n) if (r, c) in free])
            if miss:
                idx.free_count -= miss.bit_count()
                idx._occ[r] = miss
        return idx
