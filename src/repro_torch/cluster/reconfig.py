"""OCS reconfiguration planning (paper §3.3.4, §5.2; ACOS arXiv 2602.17449).

The port's own copy of ``repro/cluster/reconfig.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

A running cluster holds one global circuit state: for every optical
switch (keyed ``(dim, group, rail)`` as in ``core.topology``), the set of
port-pair circuits currently programmed.  Placing, migrating, or
shrinking a job changes the target state; the *reconfiguration plan* is
the per-switch diff (circuits to tear down + circuits to program), and
its cost model charges the scheduler timeline for the downtime.

Conventions (matching ``core.topology.configure_rails``):

* the X physical dimension connects nodes within a **row** (column
  coordinate varies): switch key ``("X", row, rail)``, ring orders are
  column coordinates;
* the Y dimension connects nodes within a **column**: ``("Y", col,
  rail)``, orders are row coordinates;
* node with coordinate ``a`` along the varying axis owns +port ``2a``
  and -port ``2a + 1``; a circuit joins a ring predecessor's +port to
  its successor's -port.

A job's ``DimensionSpec`` split is laid out mixed-radix over its
allocated rows/cols (first spec varies slowest), each spec owning a
contiguous rail range of the physical dimension.  Ring dims program the
identity ring on every rail of the range; all-to-all dims program the
Hamiltonian rail rings of Lemma 3.1, replicated round-robin over any
surplus rails.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from ..core.availability import JobAllocation
from ..core.hamiltonian import rails_for_all_to_all
from ..core.mapping import MappingResult
from ..core.topology import DimensionSpec, RailXConfig, all_to_all_rail_rings

SwitchKey = Tuple[str, int, int]          # (dim, group, rail)
Circuit = Tuple[int, int]                 # (+port, -port)
CircuitMap = Dict[SwitchKey, FrozenSet[Circuit]]


# ---------------------------------------------------------------------------
# Target circuit synthesis for one placed job
# ---------------------------------------------------------------------------


def _ring_circuits(order: Sequence[int]) -> FrozenSet[Circuit]:
    """Circuits realizing a ring over nodes in the given coordinate order."""
    L = len(order)
    if L < 2:
        return frozenset()
    return frozenset(
        (2 * order[i], 2 * order[(i + 1) % L] + 1) for i in range(L)
    )


def _subgroups(
    coords: Sequence[int], specs: Sequence[DimensionSpec], which: int
) -> List[List[int]]:
    """Split ``coords`` (mixed-radix over ``specs``) into the subgroups of
    spec ``which``: lists of coordinates that differ only in that spec's
    position, ordered by position."""
    scales = [s.scale for s in specs]
    stride = math.prod(scales[which + 1:])
    scale = scales[which]
    period = stride * scale
    groups: List[List[int]] = []
    for base in range(0, len(coords), period):
        for off in range(stride):
            member_idx = [base + off + k * stride for k in range(scale)]
            if member_idx[-1] < len(coords):
                groups.append([coords[i] for i in member_idx])
    return groups


def _rail_ranges(specs: Sequence[DimensionSpec]) -> List[Tuple[int, int]]:
    """Contiguous (start, stop) rail ids per spec, in spec order."""
    out = []
    off = 0
    for s in specs:
        out.append((off, off + s.rails))
        off += s.rails
    return out


def job_target_circuits(
    cfg: RailXConfig, mapping: MappingResult, alloc: JobAllocation
) -> CircuitMap:
    """The full OCS circuit target for one job on its allocation."""
    target: Dict[SwitchKey, Set[Circuit]] = {}

    def add(key: SwitchKey, circuits: FrozenSet[Circuit]) -> None:
        if circuits:
            target.setdefault(key, set()).update(circuits)

    for phys, groups_axis, coords in (
        ("X", alloc.rows, alloc.cols),    # X rails wire each row's columns
        ("Y", alloc.cols, alloc.rows),    # Y rails wire each column's rows
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
            for members in _subgroups(list(coords)[:need], specs, which):
                if spec.interconnect == "all_to_all":
                    rings = all_to_all_rail_rings(spec.scale)
                    if len(rings) > spec.rails:
                        raise ValueError(
                            f"dim {spec.name}: a2a scale {spec.scale} needs "
                            f"{len(rings)} rails, got {spec.rails}"
                        )
                    per_rail = [
                        [members[i] for i in ring] for ring in rings
                    ]
                    for k, rail in enumerate(range(lo, hi)):
                        order = per_rail[k % len(per_rail)]
                        for group in groups_axis:
                            add((phys, group, rail), _ring_circuits(order))
                else:  # ring
                    for rail in range(lo, hi):
                        for group in groups_axis:
                            add((phys, group, rail), _ring_circuits(members))
    return {k: frozenset(v) for k, v in target.items()}


# ---------------------------------------------------------------------------
# Diff / patch plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TxnConfig:
    """Two-phase transactional OCS apply (failure-aware reconfiguration).

    Real arrays of cheap switches do not apply a patch plan atomically:
    each switch's mirror stroke is its own physical operation and can
    fail.  When a scheduler is constructed with ``ocs_txn=TxnConfig(...)``
    every install/repatch becomes a transaction: per patched switch a
    seeded dice roll (``apply_failure_rate``) decides whether the stroke
    sticks; a failed stroke is retried up to ``max_retries`` times with
    exponential backoff (``backoff_base_s * backoff_factor**attempt``,
    charged as extra downtime), and when retries exhaust, the whole
    transaction rolls back to the last consistent circuit set — committed
    strokes are physically undone via the inverted plan (the involution
    ``ReconfigPlan.inverted``), the caller sees an abort, and the job
    demotes to the next recovery-ladder rung instead of running on
    corrupted circuits.

    ``apply_failure_rate=0.0`` (the default) makes every transaction
    commit on the first attempt with zero extra downtime — scheduling is
    then byte-identical to the non-transactional path (fingerprint-tested
    in the reference's ``tests/test_txn_migration.py``).
    """

    apply_failure_rate: float = 0.0
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SwitchPatch:
    """Reprogramming instructions for one optical switch."""

    switch: SwitchKey
    remove: FrozenSet[Circuit]
    add: FrozenSet[Circuit]

    @property
    def flips(self) -> int:
        return len(self.remove) + len(self.add)


@dataclasses.dataclass(frozen=True)
class ReconfigCostModel:
    """Downtime charged to affected jobs for a reconfiguration round.

    Switches reprogram in parallel; a switch's mirror stroke costs
    ``base_s`` regardless of circuit count (typical MEMS OCS ~25 ms) plus
    a small per-circuit programming overhead.
    """

    base_s: float = 0.025
    per_circuit_s: float = 1e-4

    def downtime(self, plan: "ReconfigPlan") -> float:
        if not plan.patches:
            return 0.0
        worst = max(p.flips for p in plan.patches)
        return self.base_s + self.per_circuit_s * worst


@dataclasses.dataclass(frozen=True)
class ReconfigPlan:
    patches: Tuple[SwitchPatch, ...]

    @property
    def circuits_flipped(self) -> int:
        return sum(p.flips for p in self.patches)

    @property
    def switches_touched(self) -> int:
        return len(self.patches)

    def inverted(self) -> "ReconfigPlan":
        """The plan undoing this one (apply o apply(inverted) = identity)."""
        return ReconfigPlan(
            tuple(
                SwitchPatch(p.switch, remove=p.add, add=p.remove)
                for p in self.patches
            )
        )


def diff_circuits(
    current: CircuitMap,
    target: CircuitMap,
    keys: Optional[Iterable[SwitchKey]] = None,
) -> ReconfigPlan:
    """Per-switch patch plan transforming ``current`` into ``target``.

    ``keys`` restricts the diff to the given switch keys; switches outside
    ``keys`` are assumed — not checked — to be identical in both maps.
    Use it when only a known subset can differ (a job's install/uninstall
    only ever touches the switches its own target names) to avoid paying
    a sort over the union of two whole global circuit maps.  The
    scheduler's hot path goes further and builds its touched-key patches
    inline (``ClusterScheduler._install``/``_uninstall``); this parameter
    serves external callers diffing restricted views.
    """
    if keys is None:
        keys = set(current) | set(target)
    patches: List[SwitchPatch] = []
    for key in sorted(keys):
        cur = current.get(key, frozenset())
        tgt = target.get(key, frozenset())
        remove, add = cur - tgt, tgt - cur
        if remove or add:
            patches.append(SwitchPatch(key, remove=remove, add=add))
    return ReconfigPlan(tuple(patches))


def apply_plan(current: CircuitMap, plan: ReconfigPlan) -> CircuitMap:
    out: Dict[SwitchKey, FrozenSet[Circuit]] = dict(current)
    for p in plan.patches:
        cur = out.get(p.switch, frozenset())
        missing = p.remove - cur
        if missing:
            raise ValueError(f"patch removes absent circuits on {p.switch}: {missing}")
        conflict = p.add & (cur - p.remove)
        if conflict:
            raise ValueError(f"patch re-adds live circuits on {p.switch}: {conflict}")
        nxt = (cur - p.remove) | p.add
        if nxt:
            out[p.switch] = nxt
        else:
            out.pop(p.switch, None)
    return out


def merge_circuits(base: CircuitMap, extra: CircuitMap) -> CircuitMap:
    """Union of two circuit maps (distinct jobs on disjoint port sets)."""
    out: Dict[SwitchKey, FrozenSet[Circuit]] = dict(base)
    for k, v in extra.items():
        out[k] = out.get(k, frozenset()) | v
    return out


# ---------------------------------------------------------------------------
# Shape-memoized circuit synthesis (coordinate relabeling)
# ---------------------------------------------------------------------------


def canonical_allocation(alloc: JobAllocation) -> JobAllocation:
    """The shape-representative allocation: rows 0..R-1, cols 0..C-1."""
    return JobAllocation(
        tuple(range(len(alloc.rows))), tuple(range(len(alloc.cols)))
    )


def relabel_circuits(
    canon: CircuitMap, rows: Sequence[int], cols: Sequence[int]
) -> CircuitMap:
    """Map a canonical-allocation circuit map onto actual coordinates.

    ``job_target_circuits`` depends on the allocation only through its
    (sorted) row/column coordinate values: X switches are keyed by row and
    their ports encode column coordinates (``+2c`` / ``-2c+1``), Y
    switches the transpose.  An order-preserving relabel of rows onto
    ``rows`` and columns onto ``cols`` therefore turns the canonical
    target into exactly the target the direct synthesis would produce
    (property-tested in the reference's ``tests/test_occupancy.py``).
    """
    out: Dict[SwitchKey, FrozenSet[Circuit]] = {}
    for (dim, group, rail), pairs in canon.items():
        if dim == "X":
            grp, coord = rows[group], cols
        else:
            grp, coord = cols[group], rows
        out[(dim, grp, rail)] = frozenset(
            (2 * coord[pa >> 1], 2 * coord[pb >> 1] + 1) for pa, pb in pairs
        )
    return out


class CircuitShapeCache:
    """Memoizes ``job_target_circuits`` (and its validation) by
    (mapping, allocation shape).

    Identical job shapes placed at different rectangles used to redo the
    Hamiltonian rail-ring synthesis and the full ring/all-to-all
    validation from scratch on every placement; both are isomorphic under
    coordinate relabeling, so one canonical synthesis per shape suffices
    and a hit costs only the O(|circuits|) relabel.

    Hit/miss statistics live in a ``repro_torch.obs`` metrics registry under
    ``circuit_cache.hits`` / ``circuit_cache.misses``; the ``hits`` /
    ``misses`` attributes remain as properties over those counters.
    """

    def __init__(self, cfg: RailXConfig, validate: bool = False, registry=None):
        from ..obs import MetricsRegistry  # local: keep cluster importable alone

        self.cfg = cfg
        self.validate = validate
        self._cache: Dict[Tuple[object, int, int], CircuitMap] = {}
        self.registry = registry if registry is not None else MetricsRegistry()
        self._hits = self.registry.counter("circuit_cache.hits")
        self._misses = self.registry.counter("circuit_cache.misses")

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    def target_for(self, mapping: MappingResult, alloc: JobAllocation) -> CircuitMap:
        key = (mapping, len(alloc.rows), len(alloc.cols))
        canon = self._cache.get(key)
        if canon is None:
            self._misses.inc()
            calloc = canonical_allocation(alloc)
            canon = job_target_circuits(self.cfg, mapping, calloc)
            if self.validate:
                validate_job_reconfig(self.cfg, mapping, calloc, canon)
            self._cache[key] = canon
        else:
            self._hits.inc()
        return relabel_circuits(canon, alloc.rows, alloc.cols)


# ---------------------------------------------------------------------------
# Validation against core.topology ring / all-to-all invariants
# ---------------------------------------------------------------------------


def _check_port_discipline(cfg: RailXConfig, circuits: CircuitMap) -> None:
    for (dim, group, rail), pairs in circuits.items():
        if dim not in ("X", "Y"):
            raise ValueError(f"bad dim {dim}")
        if not 0 <= rail < cfg.r:
            raise ValueError(f"rail {rail} out of range r={cfg.r}")
        out_ports: Set[int] = set()
        in_ports: Set[int] = set()
        for (pa, pb) in pairs:
            if pa % 2 or not pb % 2:
                raise ValueError(
                    f"{dim, group, rail}: circuit {pa}->{pb} must join a "
                    "+port (even) to a -port (odd)"
                )
            if pa >= cfg.R or pb >= cfg.R:
                raise ValueError(f"port beyond radix R={cfg.R}: {(pa, pb)}")
            if pa in out_ports:
                raise ValueError(f"{dim, group, rail}: +port {pa} double-booked")
            if pb in in_ports:
                raise ValueError(f"{dim, group, rail}: -port {pb} double-booked")
            out_ports.add(pa)
            in_ports.add(pb)


def _cycles_of(pairs: FrozenSet[Circuit]) -> List[List[int]]:
    """Decompose a switch's circuits into node-coordinate cycles."""
    succ = {pa // 2: pb // 2 for pa, pb in pairs}
    seen: Set[int] = set()
    cycles = []
    for start in sorted(succ):
        if start in seen:
            continue
        cyc = [start]
        seen.add(start)
        cur = succ[start]
        while cur != start:
            if cur in seen or cur not in succ:
                raise ValueError(f"open chain at node {cur} (not a ring)")
            cyc.append(cur)
            seen.add(cur)
            cur = succ[cur]
        cycles.append(cyc)
    return cycles


def validate_job_reconfig(
    cfg: RailXConfig,
    mapping: MappingResult,
    alloc: JobAllocation,
    circuits: Optional[CircuitMap] = None,
) -> CircuitMap:
    """Validate a job's circuit target against the topology invariants:

    * port discipline: even->odd pairs, one circuit per port, radix bound;
    * every switch's circuits decompose into closed rings (the OCS can
      only realize permutations);
    * ring dims: each subgroup's members form exactly one cycle per rail;
    * all-to-all dims: the union of rail rings makes every member pair
      adjacent (Lemma 3.1's defining property).

    Returns the validated circuit map.
    """
    if circuits is None:
        circuits = job_target_circuits(cfg, mapping, alloc)
    _check_port_discipline(cfg, circuits)

    for key, pairs in circuits.items():
        _cycles_of(pairs)  # raises if any open chain

    for phys, coords in (("X", alloc.cols), ("Y", alloc.rows)):
        specs = [s for s in mapping.specs if s.phys == phys]
        if not specs:
            continue
        need = math.prod(s.scale for s in specs)
        ranges = _rail_ranges(specs)
        groups_axis = alloc.rows if phys == "X" else alloc.cols
        for which, spec in enumerate(specs):
            if spec.scale < 2:
                continue
            lo, hi = ranges[which]
            for members in _subgroups(list(coords)[:need], specs, which):
                mset = set(members)
                for group in groups_axis:
                    if spec.interconnect == "all_to_all":
                        adj: Set[Tuple[int, int]] = set()
                        for rail in range(lo, hi):
                            pairs = circuits.get((phys, group, rail), frozenset())
                            for cyc in _cycles_of(pairs):
                                if not mset.issuperset(cyc):
                                    continue
                                L = len(cyc)
                                for i in range(L):
                                    a, b = cyc[i], cyc[(i + 1) % L]
                                    adj.add((min(a, b), max(a, b)))
                        want = {
                            (min(a, b), max(a, b))
                            for i, a in enumerate(members)
                            for b in members[i + 1:]
                        }
                        if not want.issubset(adj):
                            raise ValueError(
                                f"dim {spec.name} {phys}/{group}: all-to-all "
                                f"missing pairs {sorted(want - adj)[:4]}..."
                            )
                    else:
                        for rail in range(lo, hi):
                            pairs = circuits.get((phys, group, rail), frozenset())
                            cycles = [
                                c for c in _cycles_of(pairs) if mset.issuperset(c)
                            ]
                            covering = [c for c in cycles if set(c) == mset]
                            if len(covering) != 1:
                                raise ValueError(
                                    f"dim {spec.name} {phys}/{group} rail {rail}: "
                                    f"expected one ring over {sorted(mset)}, "
                                    f"found {len(covering)}"
                                )
    return circuits
