"""Tier-aware backlog for the cluster scheduler (SLO classes, paper §7).

The port's own copy of ``repro/cluster/backlog.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

The seed scheduler kept its backlog as a plain ``List[JobSpec]``:
``append`` for fresh submissions, ``insert(0, ...)`` for failure
requeues, and in-order iteration during ``_drain_backlog``.
``TieredBacklog`` generalizes that to SLO tiers — iteration visits
higher tiers first — while preserving the seed semantics *exactly* when
every job carries the default tier 0:

* ``push``       == ``list.append`` within the job's tier;
* ``push_front`` == ``list.insert(0, ...)`` within the job's tier;
* iteration      == tier order (descending), FIFO within a tier.

With a single tier the three operations above reduce to the plain-list
behavior, so default traces schedule byte-identically (property-tested
against a list oracle in the reference's ``tests/test_policy.py``).
Everything is deterministic: no hashing of job contents, no arrival-time
ties decided by dict order — tiers are sorted ints, and within a tier the
structure is a ``deque``.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, List

from .jobs import JobSpec


class TieredBacklog:
    """Deterministic priority backlog: higher tier first, FIFO within."""

    def __init__(self) -> None:
        self._tiers: Dict[int, Deque[JobSpec]] = {}
        # descending tier keys, maintained on push/remove so iteration
        # does not re-sort (backlogs are small; this is for determinism
        # clarity, not speed)
        self._order: List[int] = []

    # -- mutation -----------------------------------------------------------

    def _tier_queue(self, tier: int) -> Deque[JobSpec]:
        q = self._tiers.get(tier)
        if q is None:
            q = self._tiers[tier] = deque()
            self._order.append(tier)
            self._order.sort(reverse=True)
        return q

    def push(self, job: JobSpec) -> None:
        """FIFO enqueue at the back of the job's tier."""
        self._tier_queue(job.tier).append(job)

    def push_front(self, job: JobSpec) -> None:
        """Requeue at the front of the job's tier (failure/preemption
        requeues keep their place ahead of later arrivals, exactly like
        the seed's ``insert(0, ...)``)."""
        self._tier_queue(job.tier).appendleft(job)

    def remove(self, job: JobSpec) -> None:
        """Remove a job (placed or cancelled); ValueError if absent."""
        q = self._tiers.get(job.tier)
        if q is None:
            raise ValueError(f"job {job.job_id} not in backlog")
        q.remove(job)
        if not q:
            del self._tiers[job.tier]
            self._order.remove(job.tier)

    # -- queries ------------------------------------------------------------

    def __iter__(self) -> Iterator[JobSpec]:
        for tier in self._order:
            yield from self._tiers[tier]

    def jobs(self) -> List[JobSpec]:
        """Snapshot in drain order (safe to mutate the backlog while
        walking the snapshot, as ``_drain_backlog`` does)."""
        return list(self)

    def __len__(self) -> int:
        return sum(len(q) for q in self._tiers.values())

    def __bool__(self) -> bool:
        return any(self._tiers.values())

    def __contains__(self, job: JobSpec) -> bool:
        q = self._tiers.get(job.tier)
        return q is not None and job in q

    def tiers(self) -> List[int]:
        """Non-empty tiers, highest first."""
        return list(self._order)
