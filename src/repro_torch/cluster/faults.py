"""Fault domains and failure-aware circuit repair (paper §1, §7; ACOS
arXiv 2602.17449, UB-Mesh arXiv 2503.20377).

The port's own copy of ``repro/cluster/faults.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

The RailX availability story rests on the units that actually break in a
cheap-switch array: not just nodes, but the per-row/per-column OCS
switches, the per-node-per-rail transceivers behind them, and correlated
domains like a rack power feed taking out a block of rows at once.  This
module gives the cluster stack a model of those domains and the repair
math the scheduler uses to route around them.

Fault-domain model
------------------

* **node** — one grid coordinate; its capacity leaves the free set
  (``OccupancyIndex.fault``) and any hosting job enters the recovery
  ladder below.
* **switch** — one OCS unit keyed ``(dim, group, rail)`` as in
  ``reconfig``: an X switch carries one rail of one row, a Y switch one
  rail of one column.  Failing it downs *every circuit it hosts*; the
  nodes it serves stay healthy, so affected jobs lose one rail of
  bandwidth, not their workers.
* **link** — one transceiver ``(node, dim, rail)``: the node's port pair
  on a single switch.  Only circuits through that port pair die.
* **row_power** (correlated) — a rack power feed spanning a group of
  consecutive rows; failing it emits a simultaneous ``NodeFail`` burst
  for every up node in the group and one shared recovery.

Recovery ladder
---------------

On a fault touching a running job the scheduler tries, in order:

1. **repair** — re-synthesize the job's ring/all-to-all circuits over the
   *surviving* rails of each dimension group (:func:`synthesize_degraded`).
   Ring dims simply drop the dead replica (zero strokes on live
   switches); all-to-all dims keep Lemma-3.1 pattern coverage by
   reassigning a minimal set of donor rails (a few bypass strokes,
   costed by ``ReconfigCostModel`` like any patch).  The job keeps its
   nodes and continues at ``base_goodput x factor`` where ``factor`` is
   the worst surviving-rail fraction of any dimension group.
2. **partial-migrate** — when repair is impossible, replace only the
   irreparable rows/columns (:func:`irreparable_lines` names them,
   ``placement.partial_refit`` finds substitutes) and keep the surviving
   lines pinned.
3. **migrate** — full-size re-placement elsewhere (checkpoint-restore).
4. **shrink** — elastic restart with the DP degree halved.
5. **requeue** — back to the backlog with the remaining work.

Adding a new fault domain
-------------------------

Declare the event pair in ``events.py`` (fail priority 0, recover
priority 1), give ``trace.iter_fault_domain_trace`` an MTBF/MTTR knob
and an entity enumeration for it, teach
``ClusterScheduler._dispatch`` how the fault maps onto nodes / switch
keys / port pairs (everything downstream — repair, quarantine, MTTR
accounting — operates on those three primitives), and extend
``obs.schema.KNOWN_SPANS`` if the handler opens new spans.  The chaos
invariants in ``benchmarks/bench_chaos.py`` (work conservation, no lost
jobs, replay determinism, bounded degradation) apply unchanged to any
domain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..core.availability import JobAllocation
from ..core.mapping import MappingResult
from ..core.topology import RailXConfig, all_to_all_rail_rings
from .reconfig import (
    Circuit,
    CircuitMap,
    SwitchKey,
    _rail_ranges,
    _ring_circuits,
    _subgroups,
)

Coord = Tuple[int, int]
LinkId = Tuple[Coord, str, int]           # (node, dim, rail): one transceiver


# ---------------------------------------------------------------------------
# Fault-domain descriptors (consumed by trace.iter_fault_domain_trace)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultDomain:
    """One failure domain in the MTBF/MTTR trace generator.

    ``kind`` is one of ``node`` / ``switch`` / ``link`` / ``row_power``;
    ``entities`` the number of independent units of that kind in the
    installation (the cluster-level failure rate is
    ``entities / mtbf_s``).  ``mtbf_s <= 0`` disables the domain.
    """

    kind: str
    entities: int
    mtbf_s: float
    mttr_s: float

    @property
    def rate(self) -> float:
        return self.entities / self.mtbf_s if self.mtbf_s > 0 else 0.0


# ---------------------------------------------------------------------------
# Link helpers
# ---------------------------------------------------------------------------


def link_switch_key(link: LinkId) -> SwitchKey:
    """The switch whose ports the transceiver occupies: an X-rail link of
    node (r, c) lands on switch ("X", r, rail), a Y-rail link on
    ("Y", c, rail)."""
    (r, c), dim, rail = link
    return (dim, r if dim == "X" else c, rail)


def link_ports(link: LinkId) -> Tuple[int, int]:
    """The (+port, -port) pair the transceiver drives on its switch."""
    (r, c), dim, rail = link
    a = c if dim == "X" else r
    return (2 * a, 2 * a + 1)


def link_hits_circuits(link: LinkId, circuits: CircuitMap) -> bool:
    """True iff any programmed circuit runs through the link's port pair."""
    pairs = circuits.get(link_switch_key(link))
    if not pairs:
        return False
    out_p, in_p = link_ports(link)
    return any(pa == out_p or pb == in_p for pa, pb in pairs)


# ---------------------------------------------------------------------------
# Degraded circuit synthesis (the repair rung of the ladder)
# ---------------------------------------------------------------------------


def _stable_pattern_assignment(
    lo: int, live: Sequence[int], patterns: int
) -> Dict[int, int]:
    """Assign Lemma-3.1 ring patterns to the surviving rails of an
    all-to-all rail range so that every pattern stays covered while
    reprogramming as few rails as possible.

    Each live rail first keeps its fault-free pattern ``(rail - lo) %
    patterns``.  Patterns left uncovered then draft donors: the pattern
    with the most replicas (ties: lowest pattern id) gives up its highest
    rail, missing patterns filled in ascending order.  With ``len(live)
    >= patterns`` the pigeonhole guarantees a donor with >= 2 replicas at
    every step, so coverage is always reachable and no donor pattern is
    ever emptied.  With no faults the assignment is exactly the
    fault-free one (zero reprogrammed rails).
    """
    assign = {rail: (rail - lo) % patterns for rail in live}
    counts = [0] * patterns
    for p in assign.values():
        counts[p] += 1
    for missing in [p for p in range(patterns) if counts[p] == 0]:
        donor_pat = max(range(patterns), key=lambda p: (counts[p], -p))
        donor_rail = max(r for r, p in assign.items() if p == donor_pat)
        assign[donor_rail] = missing
        counts[donor_pat] -= 1
        counts[missing] += 1
    return assign


def synthesize_degraded(
    cfg: RailXConfig,
    mapping: MappingResult,
    alloc: JobAllocation,
    failed_switches: FrozenSet[SwitchKey] = frozenset(),
    failed_links: FrozenSet[LinkId] = frozenset(),
) -> Optional[Tuple[CircuitMap, float]]:
    """The job's circuit target avoiding dead switches/transceivers, plus
    the bandwidth-degradation factor, or None when the fault set is
    irreparable for this job in place.

    Mirrors ``reconfig.job_target_circuits`` per (spec, group, subgroup),
    but restricted to the rails still alive for that group: a rail is
    dead when its switch ``(phys, group, rail)`` failed or any subgroup
    member's transceiver on it failed.  Ring dims need >= 1 live rail
    (they run the identical ring on every replica); all-to-all dims need
    >= len(rail rings) live rails to keep Lemma-3.1 pair coverage, with
    :func:`_stable_pattern_assignment` choosing which survivors carry
    which pattern.  The returned factor is the minimum live-rail fraction
    over all groups — the scheduler scales the job's goodput by it.

    With empty fault sets the result equals ``job_target_circuits``
    exactly with factor 1.0 (property-tested in the reference's
    ``tests/test_faults.py``).
    """
    target: Dict[SwitchKey, Set[Circuit]] = {}
    factor = 1.0

    def add(key: SwitchKey, circuits: FrozenSet[Circuit]) -> None:
        if circuits:
            target.setdefault(key, set()).update(circuits)

    for phys, groups_axis, coords in (
        ("X", alloc.rows, alloc.cols),
        ("Y", alloc.cols, alloc.rows),
    ):
        specs = [s for s in mapping.specs if s.phys == phys]
        if not specs:
            continue
        need = math.prod(s.scale for s in specs)
        if need > len(coords):
            raise ValueError(
                f"{phys} split scale {need} exceeds allocation extent {len(coords)}"
            )
        ranges = _rail_ranges(specs)
        for which, spec in enumerate(specs):
            if spec.scale < 2:
                continue
            lo, hi = ranges[which]
            total = hi - lo
            for members in _subgroups(list(coords)[:need], specs, which):
                if spec.interconnect == "all_to_all":
                    rings = all_to_all_rail_rings(spec.scale)
                    per_rail = [[members[i] for i in ring] for ring in rings]
                else:
                    per_rail = None
                for group in groups_axis:
                    live = [
                        rail for rail in range(lo, hi)
                        if (phys, group, rail) not in failed_switches
                        and not any(
                            (_line_node(phys, group, m), phys, rail)
                            in failed_links
                            for m in members
                        )
                    ]
                    if per_rail is not None:
                        if len(live) < len(per_rail):
                            return None
                        assign = _stable_pattern_assignment(
                            lo, live, len(per_rail)
                        )
                        for rail in live:
                            add(
                                (phys, group, rail),
                                _ring_circuits(per_rail[assign[rail]]),
                            )
                    else:
                        if not live:
                            return None
                        ring = _ring_circuits(members)
                        for rail in live:
                            add((phys, group, rail), ring)
                    factor = min(factor, len(live) / total)
    return {k: frozenset(v) for k, v in target.items()}, factor


def _line_node(phys: str, group: int, coord: int) -> Coord:
    """Grid coordinate of a subgroup member: X groups are rows (member
    coordinate is the column), Y groups the transpose."""
    return (group, coord) if phys == "X" else (coord, group)


def faults_hit_target(
    target: CircuitMap,
    failed_switches: Set[SwitchKey],
    failed_links: Set[LinkId],
) -> bool:
    """True iff any dead switch or transceiver carries a target circuit."""
    if failed_switches and not failed_switches.isdisjoint(target):
        return True
    return any(link_hits_circuits(ln, target) for ln in failed_links)


def irreparable_lines(
    cfg: RailXConfig,
    mapping: MappingResult,
    alloc: JobAllocation,
    failed_switches: FrozenSet[SwitchKey] = frozenset(),
    failed_links: FrozenSet[LinkId] = frozenset(),
) -> Tuple[FrozenSet[int], FrozenSet[int]]:
    """The allocation rows and columns whose surviving rails cannot carry
    the job's circuits — exactly the lines that make
    :func:`synthesize_degraded` return None.

    Mirrors its live-rail census: a line (an X group = grid row, a Y
    group = grid column) is irreparable when, for some spec splitting
    along it, some subgroup's live-rail count drops below what the spec
    needs — >= 1 rail for ring dims, >= the Lemma-3.1 ring count for
    all-to-all dims.  Replacing the line cures both failure modes it can
    suffer: its own dead switches stay behind, and its members'
    transceivers are per-node hardware, so substitute nodes bring fresh
    ones.  The partial-migration rung replaces exactly these lines
    (``placement.partial_refit``) and repatches the diff, keeping every
    other line's circuits pinned.

    With ``synthesize_degraded`` returning a repair, both sets are empty.
    """
    bad_rows: Set[int] = set()
    bad_cols: Set[int] = set()
    for phys, groups_axis, coords in (
        ("X", alloc.rows, alloc.cols),
        ("Y", alloc.cols, alloc.rows),
    ):
        specs = [s for s in mapping.specs if s.phys == phys]
        if not specs:
            continue
        need = math.prod(s.scale for s in specs)
        ranges = _rail_ranges(specs)
        bad = bad_rows if phys == "X" else bad_cols
        for which, spec in enumerate(specs):
            if spec.scale < 2:
                continue
            lo, hi = ranges[which]
            if spec.interconnect == "all_to_all":
                needed = len(all_to_all_rail_rings(spec.scale))
            else:
                needed = 1
            for members in _subgroups(list(coords)[:need], specs, which):
                for group in groups_axis:
                    if group in bad:
                        continue
                    live = sum(
                        1 for rail in range(lo, hi)
                        if (phys, group, rail) not in failed_switches
                        and not any(
                            (_line_node(phys, group, m), phys, rail)
                            in failed_links
                            for m in members
                        )
                    )
                    if live < needed:
                        bad.add(group)
    return frozenset(bad_rows), frozenset(bad_cols)


# ---------------------------------------------------------------------------
# Flap quarantine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuarantineConfig:
    """Exponential-backoff burn-in for flapping entities.

    An entity reaching ``threshold`` failures is held out of service past
    its repair for ``base_s * factor**(fails - threshold)`` seconds; a
    completed burn-in resets its count.
    """

    threshold: int = 3
    base_s: float = 3600.0
    factor: float = 2.0


class FlapTracker:
    """Per-entity failure counter implementing :class:`QuarantineConfig`."""

    def __init__(self, cfg: Optional[QuarantineConfig] = None):
        self.cfg = cfg if cfg is not None else QuarantineConfig()
        self._fails: Dict[object, int] = {}

    def record_fail(self, entity: object) -> int:
        n = self._fails.get(entity, 0) + 1
        self._fails[entity] = n
        return n

    def fail_count(self, entity: object) -> int:
        return self._fails.get(entity, 0)

    def quarantine_s(self, entity: object) -> Optional[float]:
        """Burn-in seconds owed at the entity's next repair, or None if it
        has not flapped enough to be quarantined."""
        n = self._fails.get(entity, 0)
        if n < self.cfg.threshold:
            return None
        return self.cfg.base_s * self.cfg.factor ** (n - self.cfg.threshold)

    def release(self, entity: object) -> None:
        """A completed burn-in clears the entity's record."""
        self._fails.pop(entity, None)
