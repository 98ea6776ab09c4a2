"""Discrete-event machinery for the cluster scheduler.

The port's own copy of ``repro/cluster/events.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

Events are totally ordered by (time, priority, seq): the sequence number
makes the loop deterministic under simultaneous events, and priority puts
frees/recoveries ahead of submissions at the same instant (so a job
finishing at t can make room for a job submitted at t).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Iterable, List, Optional, Tuple, Union

from .jobs import JobSpec

Coord = Tuple[int, int]
SwitchKey = Tuple[str, int, int]      # (dim, group, rail) as in reconfig
LinkId = Tuple[Coord, str, int]       # (node, dim, rail): one transceiver


@dataclasses.dataclass(frozen=True)
class JobSubmit:
    time: float
    job: JobSpec


@dataclasses.dataclass(frozen=True)
class JobFinish:
    """Completion of one run segment of a job.

    ``epoch`` is the job's run-segment counter at scheduling time: every
    placement (initial, migrate, shrink, requeue-replace) starts a new
    segment, so a finish is current iff its epoch matches the running
    job's.  This replaces the fragile float comparison of expected-finish
    timestamps (service times stretched by goodput ratios accumulate
    rounding error).
    """

    time: float
    job_id: int
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class NodeFail:
    time: float
    node: Coord


@dataclasses.dataclass(frozen=True)
class NodeRecover:
    time: float
    node: Coord


@dataclasses.dataclass(frozen=True)
class SwitchFail:
    """An OCS row/column switch dies: every circuit it hosts goes dark.

    The nodes it serves stay healthy — only the rail it carries is lost,
    so affected jobs first attempt a circuit *repair* (re-synthesis over
    the surviving rails) before the migrate/shrink/requeue ladder.
    """

    time: float
    switch: SwitchKey


@dataclasses.dataclass(frozen=True)
class SwitchRecover:
    """A failed switch returns (blank: its circuits must be reprogrammed)."""

    time: float
    switch: SwitchKey


@dataclasses.dataclass(frozen=True)
class LinkFail:
    """One node's transceiver on one rail dies: circuits through that
    node's port pair on switch ``(dim, line-of-node, rail)`` go dark."""

    time: float
    node: Coord
    dim: str                          # "X" (row rail) or "Y" (column rail)
    rail: int

    @property
    def link(self) -> LinkId:
        return (self.node, self.dim, self.rail)


@dataclasses.dataclass(frozen=True)
class LinkRecover:
    time: float
    node: Coord
    dim: str
    rail: int

    @property
    def link(self) -> LinkId:
        return (self.node, self.dim, self.rail)


@dataclasses.dataclass(frozen=True)
class QuarantineRelease:
    """Internal event: a flap-quarantined entity finishes its burn-in and
    rejoins placement.  Scheduled by the scheduler itself (never appears
    in input traces)."""

    time: float
    kind: str                         # "node" | "switch" | "link"
    node: Optional[Coord] = None
    switch: Optional[SwitchKey] = None
    link: Optional[LinkId] = None


@dataclasses.dataclass(frozen=True)
class RateUpdate:
    """One sample of a serving service's request rate (requests/s).

    Emitted by the diurnal trace generator
    (``serving_traces.iter_diurnal_trace``); the scheduler closes the
    service's queue-accounting interval at ``time`` using the previous
    rate, then adopts ``rate_rps`` for the next one.  Ignored when the
    scheduler has no serving configuration."""

    time: float
    service_id: int
    rate_rps: float


@dataclasses.dataclass(frozen=True)
class ReplicaScale:
    """Grow or shrink a serving service to ``target_replicas``.

    Emitted by the autoscaler policy (and, in tests, injectable as a
    manual scaling action); each added replica goes through the normal
    placement + OCS patch-plan machinery, each removed replica releases
    its rectangle and circuits."""

    time: float
    service_id: int
    target_replicas: int
    reason: str = "autoscale"         # "autoscale" | "manual"


Event = Union[
    JobSubmit, JobFinish, NodeFail, NodeRecover,
    SwitchFail, SwitchRecover, LinkFail, LinkRecover, QuarantineRelease,
    RateUpdate, ReplicaScale,
]

# same-instant ordering: failures first (they may evict), then finishes and
# recoveries (they free capacity), then submissions (they consume it).
# ReplicaScale sits with the capacity events: an autoscaler decision made
# at t applies before the same-instant training submissions contend for
# the nodes; RateUpdate rides with submissions (it only samples load).
_PRIORITY = {
    NodeFail: 0, SwitchFail: 0, LinkFail: 0,
    JobFinish: 1, NodeRecover: 1, SwitchRecover: 1, LinkRecover: 1,
    QuarantineRelease: 1, ReplicaScale: 1,
    JobSubmit: 2, RateUpdate: 2,
}


class EventQueue:
    """Deterministic min-heap of events."""

    def __init__(self, events: Iterable[Event] = ()):  # noqa: D107
        self._heap: List[Tuple[float, int, int, Event]] = []
        self._seq = itertools.count()
        for ev in events:
            self.push(ev)

    def push(self, ev: Event) -> None:
        heapq.heappush(
            self._heap, (ev.time, _PRIORITY[type(ev)], next(self._seq), ev)
        )

    def pop(self) -> Optional[Event]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[-1]

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
