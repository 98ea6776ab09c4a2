"""Cluster metrics: flow-model goodput per placed job + timeline accounting.

The port's own copy of ``repro/cluster/metrics.py``.  It imports nothing of
``repro``.  The goodput's routing is the one piece of the cluster that runs
on a device: ``estimate_goodput`` lowers the job network to a
``CompiledNetwork`` on ``device`` (the card unless the caller passes
``"cpu"``) and routes through ``core.compiled_flow.route_demands``, whose
hot loops are the hand-written kernels of ``kernels/flow``.  The float it
returns is the reference's bit for bit on either device.

Goodput (paper §6 figure-of-merit, adapted): build a node-granularity
``core.simulator.FlowNetwork`` over the job's allocation wired exactly as
its reconfigured rails (ring links per ring dim, Hamiltonian rail-ring
links per all-to-all dim), inject the job's Table-4 per-iteration traffic
as demands, and compare the bottleneck-link serialization time against
the ideal (perfectly spread) time.  ``goodput = t_ideal / t_actual`` in
(0, 1]; the scheduler stretches each job's service time by 1/goodput.

Intra-node TP traffic never crosses the OCS fabric and is excluded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..core.availability import JobAllocation
from ..core.compiled_flow import (
    CompiledNetwork,
    max_utilization_compiled,
    route_demands,
)
from ..core.mapping import MappingResult
from ..core.simulator import FlowNetwork
from ..core.topology import DimensionSpec, RailXConfig, all_to_all_rail_rings
from .jobs import JobSpec, job_comm_volumes
from .reconfig import _rail_ranges, _subgroups

Coord = Tuple[int, int]


def _spec_groups(
    mapping: MappingResult, alloc: JobAllocation, phys: str
) -> List[Tuple[DimensionSpec, List[List[int]], Tuple[int, int]]]:
    """(spec, subgroups-of-coords, rail range) for each spec on ``phys``."""
    specs = [s for s in mapping.specs if s.phys == phys]
    coords = list(alloc.cols if phys == "X" else alloc.rows)
    if not specs:
        return []
    need = math.prod(s.scale for s in specs)
    ranges = _rail_ranges(specs)
    out = []
    for which, spec in enumerate(specs):
        if spec.scale < 2:
            continue
        out.append((spec, _subgroups(coords[:need], specs, which), ranges[which]))
    return out


def _vertex(phys: str, line: int, coord: int) -> Coord:
    """Node vertex from a (row-or-column line, coordinate along it)."""
    return (line, coord) if phys == "X" else (coord, line)


def build_job_network(
    cfg: RailXConfig, mapping: MappingResult, alloc: JobAllocation
) -> FlowNetwork:
    """Node-granularity flow network of one job's reconfigured rails."""
    net = FlowNetwork()
    for phys in ("X", "Y"):
        lines = alloc.rows if phys == "X" else alloc.cols
        for spec, groups, (lo, hi) in _spec_groups(mapping, alloc, phys):
            rails = hi - lo
            for members in groups:
                if spec.interconnect == "all_to_all":
                    rings = all_to_all_rail_rings(spec.scale)
                    for k in range(rails):
                        ring = rings[k % len(rings)]
                        order = [members[i] for i in ring]
                        for i in range(len(order)):
                            a, b = order[i], order[(i + 1) % len(order)]
                            if a == b:
                                continue
                            for line in lines:
                                net.add_link(
                                    _vertex(phys, line, a),
                                    _vertex(phys, line, b),
                                    1.0,
                                )
                else:
                    for i in range(len(members)):
                        a, b = members[i], members[(i + 1) % len(members)]
                        if a == b:
                            continue
                        for line in lines:
                            net.add_link(
                                _vertex(phys, line, a),
                                _vertex(phys, line, b),
                                float(rails),
                            )
    return net


def build_job_network_torus(
    cfg: RailXConfig, mapping: MappingResult, alloc: JobAllocation
) -> FlowNetwork:
    """The same job's rails on a static 2-D torus (no OCS): every
    dimension group is a fixed neighbor ring over the subgroup's
    coordinates with the full rail trunk on each hop.  Ring dims match
    the reconfigured fabric hop-for-hop, but all-to-all dims have no
    Hamiltonian rail rings to spread over and must route multi-hop
    around the one fixed ring — the goodput gap to ``railx-hyperx`` is
    precisely the reconfigurability advantage §7 argues for."""
    net = FlowNetwork()
    for phys in ("X", "Y"):
        lines = alloc.rows if phys == "X" else alloc.cols
        for spec, groups, (lo, hi) in _spec_groups(mapping, alloc, phys):
            rails = hi - lo
            for members in groups:
                for i in range(len(members)):
                    a, b = members[i], members[(i + 1) % len(members)]
                    if a == b:
                        continue
                    for line in lines:
                        net.add_link(
                            _vertex(phys, line, a),
                            _vertex(phys, line, b),
                            float(rails),
                        )
    return net


def build_job_network_torus3d(
    cfg: RailXConfig, mapping: MappingResult, alloc: JobAllocation
) -> FlowNetwork:
    """The same job's rails on a static 3-D torus (TPUv4-class, no OCS).

    Abstraction: the third torus axis folds each dimension subgroup's
    line into a ``k x ceil(s/k)`` sub-torus (``k = isqrt(s)``), so every
    member reaches stride-1 neighbors *and* stride-``k`` fold neighbors.
    The rail trunk splits 2:1 between the in-line ring and the folded
    axis (a torus node spends its per-dim ports across the extra axis).
    Subgroups too short to fold (``s`` < 4) keep the plain ring at full
    trunk width — identical to :func:`build_job_network_torus` there.
    All-to-all dims still lack Hamiltonian rail rings, but the fold's
    stride-``k`` chords cut their worst-case detour from ``s/2`` to
    about ``sqrt(s)`` hops — the 3-D torus sits between the 2-D torus
    and the reconfigured fabric, which is exactly where §7 places it."""
    net = FlowNetwork()
    for phys in ("X", "Y"):
        lines = alloc.rows if phys == "X" else alloc.cols
        for spec, groups, (lo, hi) in _spec_groups(mapping, alloc, phys):
            rails = hi - lo
            for members in groups:
                s = len(members)
                k = math.isqrt(s)
                fold = k >= 2 and s >= 4
                ring_cap = rails * (2.0 / 3.0) if fold else float(rails)
                for i in range(s):
                    a, b = members[i], members[(i + 1) % s]
                    if a == b:
                        continue
                    for line in lines:
                        net.add_link(
                            _vertex(phys, line, a),
                            _vertex(phys, line, b),
                            ring_cap,
                        )
                if not fold:
                    continue
                fold_cap = rails / 3.0
                for i in range(s):
                    a, b = members[i], members[(i + k) % s]
                    if a == b:
                        continue
                    for line in lines:
                        net.add_link(
                            _vertex(phys, line, a),
                            _vertex(phys, line, b),
                            fold_cap,
                        )
    return net


def build_job_network_rail_only(
    cfg: RailXConfig, mapping: MappingResult, alloc: JobAllocation
) -> FlowNetwork:
    """The same job on a rail-only fabric (arXiv 2307.12169): each
    dimension subgroup's rail range terminates in one electrical rail
    switch per line, so members reach each other in two hops through the
    hub with the aggregate rail capacity on their uplink.  Any-to-any
    within a rail group is free of ring hops (all-to-all dims don't pay
    the torus's multi-hop detour) but every byte crosses the shared
    uplink twice — a different bottleneck shape than either the torus or
    the reconfigured point-to-point circuits."""
    net = FlowNetwork()
    for phys in ("X", "Y"):
        lines = alloc.rows if phys == "X" else alloc.cols
        for spec, groups, (lo, hi) in _spec_groups(mapping, alloc, phys):
            rails = hi - lo
            for gi, members in enumerate(groups):
                for line in lines:
                    hub = ("rail-sw", phys, line, lo, gi)
                    for m in dict.fromkeys(members):
                        net.add_link(
                            _vertex(phys, line, m), hub, float(rails)
                        )
    return net


def estimate_goodput(
    cfg: RailXConfig,
    job: JobSpec,
    mapping: MappingResult,
    alloc: JobAllocation,
    max_flow_nodes: int = 512,
    fabric: str = "railx-hyperx",
    device=None,
) -> float:
    """Route the job's Table-4 traffic through the flow model.

    Returns t_ideal / t_actual in (0, 1].  Allocations larger than
    ``max_flow_nodes`` are evaluated on a trimmed representative
    sub-rectangle (the wiring is translation-symmetric across lines, so
    a single line per physical dimension captures the bottleneck).

    The job-network builder is resolved by ``fabric`` name through the
    ``repro_torch.arch`` registry (``job_network`` capability); the default
    ``railx-hyperx`` registration is :func:`build_job_network`, so the
    default goodput is byte-identical to the pre-registry path.

    The network is lowered and routed on ``device`` (``device.resolve``:
    the card unless the caller passes ``"cpu"``).  The demand dict is built
    in the reference's order: ``route_demands`` folds each edge's
    contributions in that order, so the order fixes the float's bits.
    """
    vols = job_comm_volumes(job)           # bytes per iteration by dim name
    if alloc.size > max_flow_nodes:
        # rows are replicated "lines" for the X specs but ring *members*
        # for the Y specs: never trim below the Y split's required extent
        # or whole subgroups (and their traffic) silently vanish
        need_y = math.prod(
            s.scale for s in mapping.specs if s.phys == "Y"
        )
        keep_r = max(1, need_y, max_flow_nodes // max(1, len(alloc.cols)))
        rows = alloc.rows[:keep_r]
        cols = alloc.cols
        if keep_r * len(cols) > max_flow_nodes:
            # mirror for column-heavy (X-extent) allocations: cols are
            # replicated lines for the Y specs but ring members for the X
            # specs, so never trim below the X split's required extent
            need_x = math.prod(
                s.scale for s in mapping.specs if s.phys == "X"
            )
            keep_c = max(1, need_x, max_flow_nodes // max(1, keep_r))
            cols = cols[:keep_c]
        alloc = JobAllocation(rows, cols)
    from ..arch import get as _get_arch  # lazy: repro_torch.arch imports cluster

    net = _get_arch(fabric).require("job_network").job_network(
        cfg, mapping, alloc
    )

    demands: Dict[Tuple[Coord, Coord], float] = {}

    def add_demand(a: Coord, b: Coord, v: float) -> None:
        if a != b and v > 0:
            demands[(a, b)] = demands.get((a, b), 0.0) + v

    ideal_t = 0.0
    port_bw = cfg.port_gbps * 1e9 / 8      # bytes/s, one direction
    for phys in ("X", "Y"):
        lines = alloc.rows if phys == "X" else alloc.cols
        for spec, groups, (lo, hi) in _spec_groups(mapping, alloc, phys):
            v = vols.get(spec.name, 0.0)
            if v <= 0:
                continue
            rails = hi - lo
            ideal_t += v / (2 * rails * port_bw)
            for members in groups:
                s = len(members)
                for line in lines:
                    if spec.interconnect == "all_to_all":
                        per_pair = v / max(1, s - 1)
                        for i, a in enumerate(members):
                            for b in members[i + 1:]:
                                add_demand(
                                    _vertex(phys, line, a),
                                    _vertex(phys, line, b),
                                    per_pair,
                                )
                    else:
                        # ring traffic split over both directions (each rail
                        # is a +/- pair); ring all-reduce ~ 2(s-1)/s * V
                        factor = 2.0 * (s - 1) / s if spec.name == "dp" else 1.0
                        for i in range(s):
                            a = _vertex(phys, line, members[i])
                            b = _vertex(phys, line, members[(i + 1) % s])
                            add_demand(a, b, v * factor / 2)
                            add_demand(b, a, v * factor / 2)
    if not demands or ideal_t <= 0:
        return 1.0
    # lower once, route with the flow kernels (loads and the bottleneck
    # utilization are bit-identical to the reference's seed dict engine:
    # tests/test_torch_flow.py)
    cn = CompiledNetwork.from_flow_network(net, device=device)
    vid = cn.vertex_id
    load = route_demands(
        cn, {(vid[a], vid[b]): v for (a, b), v in demands.items()}
    )
    util = max_utilization_compiled(cn, load)  # bytes over unit-cap links
    if not math.isfinite(util) or util <= 0:
        return 1.0
    actual_t = util / port_bw              # bottleneck serialization seconds
    if actual_t <= 0:
        return 1.0
    return max(1e-3, min(1.0, ideal_t / actual_t))


class GoodputCache:
    """Memoizes ``estimate_goodput`` by (job signature, allocation shape).

    The flow network built by ``build_job_network`` and the ECMP routing
    over it are isomorphic under an order-preserving relabel of the
    allocation's rows/columns: the construction loops iterate coordinates
    in sorted order, so demands, adjacency insertion order, BFS visit
    order and float accumulation order all map 1:1.  The bottleneck
    utilization — hence the goodput scalar — is therefore bit-identical
    for any two same-shape allocations of the same job signature, and one
    routing per (arch, plan, shape, rows, cols) key suffices.

    Hit/miss statistics live in a ``repro_torch.obs`` metrics registry under
    ``goodput_cache.hits`` / ``goodput_cache.misses``; the ``hits`` /
    ``misses`` attributes remain as properties over those counters.  A miss
    routes on ``device`` (the scheduler's, resolved once).
    """

    def __init__(
        self, cfg: RailXConfig, registry=None, fabric: str = "railx-hyperx",
        device=None,
    ):
        from ..obs import MetricsRegistry  # local: keep cluster importable alone

        self.cfg = cfg
        self.fabric = fabric
        self.device = device
        self._cache: Dict[Tuple[object, ...], float] = {}
        self.registry = registry if registry is not None else MetricsRegistry()
        self._hits = self.registry.counter("goodput_cache.hits")
        self._misses = self.registry.counter("goodput_cache.misses")

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    def goodput_for(
        self, job: JobSpec, mapping: MappingResult, alloc: JobAllocation
    ) -> float:
        key = (
            job.arch, job.plan, job.shape, mapping,
            len(alloc.rows), len(alloc.cols),
        )
        g = self._cache.get(key)
        if g is None:
            self._misses.inc()
            g = estimate_goodput(
                self.cfg, job, mapping, alloc, fabric=self.fabric,
                device=self.device,
            )
            self._cache[key] = g
        else:
            self._hits.inc()
        return g


# ---------------------------------------------------------------------------
# Timeline accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunSegment:
    """One completed run segment of a job: a placement's goodput/footprint
    and the seconds of goodput-1.0 work it actually executed."""

    goodput: float
    nodes: int
    work_s: float                 # work executed in this segment (g = 1.0)


@dataclasses.dataclass
class JobRecord:
    job: JobSpec
    submit_t: float
    start_t: Optional[float] = None
    finish_t: Optional[float] = None
    nodes: int = 0                # footprint of the latest placement
    goodput: float = 1.0          # goodput of the latest placement
    reconfig_downtime_s: float = 0.0
    migrations: int = 0
    shrinks: int = 0
    expansions: int = 0
    preemptions: int = 0          # times this job was preemption-evicted
    repairs: int = 0              # in-place circuit repairs (degrade/heal)
    partial_migrations: int = 0   # dead-line-only moves (ladder rung 2)
    lost_work_s: float = 0.0      # work lost to checkpoint rollback
    segments: List[RunSegment] = dataclasses.field(default_factory=list)

    @property
    def queueing_delay(self) -> Optional[float]:
        return None if self.start_t is None else self.start_t - self.submit_t

    @property
    def segment_count(self) -> int:
        return len(self.segments)

    def end_segment(self, goodput: float, nodes: int, work_s: float) -> None:
        """Record a finished run segment (called at finish/evict time, when
        the executed work is known)."""
        self.segments.append(RunSegment(goodput, nodes, work_s))

    def weighted_goodput(self) -> float:
        """Work-weighted mean goodput over completed run segments.

        ``goodput`` alone is the *latest* placement's value; a job that
        migrated or shrank ran earlier segments at different goodputs, and
        averaging only the final value misreports the service the job
        actually received.  Falls back to the latest placement's goodput
        while no segment has completed (job still in its first segment).
        """
        total = sum(s.work_s for s in self.segments)
        if total <= 0:
            return self.goodput
        return sum(s.goodput * s.work_s for s in self.segments) / total


@dataclasses.dataclass
class TimelineMetrics:
    """Integrated cluster metrics maintained by the scheduler loop."""

    grid_nodes: int
    records: Dict[int, JobRecord] = dataclasses.field(default_factory=dict)
    events_processed: int = 0
    util_node_seconds: float = 0.0         # occupied node-seconds
    healthy_node_seconds: float = 0.0      # healthy node-seconds
    reconfig_rounds: int = 0
    circuits_flipped: int = 0
    total_downtime_s: float = 0.0
    placement_attempts: int = 0            # _try_place calls (incl. gated-out)
    placement_scans: int = 0               # attempts that ran a policy scan
    preemptions: int = 0                   # victim evictions (policy engine)
    expansions: int = 0                    # shrunken jobs grown back
    # survivability (reported via survivability_summary(), never summary():
    # the default-trace summary keys stay exactly the seed set)
    node_faults: int = 0                   # NodeFail events observed
    switch_faults: int = 0                 # SwitchFail events observed
    link_faults: int = 0                   # LinkFail events observed
    repairs: int = 0                       # successful in-place circuit repairs
    repair_fallbacks: int = 0              # repairs that fell to the ladder
    partial_migrations: int = 0            # dead-line-only moves (rung 2)
    lost_work_s: float = 0.0               # checkpoint-rollback work lost
    quarantines: int = 0                   # entities sent to flap burn-in
    mttr_total_s: float = 0.0              # summed fail->restore intervals
    mttr_count: int = 0                    # restores with a matching fail
    degraded_work_s: float = 0.0           # work run in degraded segments
    degraded_factor_work_s: float = 0.0    # sum(factor * work) over those
    # transactional OCS apply (all zero when ocs_txn is off)
    txn_commits: int = 0                   # committed transactions
    txn_retries: int = 0                   # per-switch strokes that re-rolled
    txn_retry_strokes: int = 0             # mirror strokes spent on retries
    txn_rollbacks: int = 0                 # retry-exhausted transactions
    txn_rollback_strokes: int = 0          # mirror strokes spent undoing them
    # serving digital twin (reported via serving_summary(), never
    # summary(); all zero with serving=None)
    replica_scale_events: int = 0          # ReplicaScale events applied
    serving_scale_ups: int = 0             # replicas successfully added
    serving_scale_downs: int = 0           # replicas removed by scale-down
    serving_scale_failures: int = 0        # scale-ups that found no room
    serving_preemptions: int = 0           # training victims of replicas
    serving_repairs: int = 0               # in-place replica circuit repairs
    serving_migrations: int = 0            # fault-evicted replicas re-placed
    serving_fault_evictions: int = 0       # replicas lost to faults (no room)
    circuit_cache_hits: int = 0
    circuit_cache_misses: int = 0
    goodput_cache_hits: int = 0
    goodput_cache_misses: int = 0
    _last_t: float = 0.0
    _occupied: int = 0
    _healthy: int = 0
    # scheduler-installed callback pulling live cache/solver counters into
    # the fields above; called by summary()/policy_summary() so a mid-run
    # (or post-exception) read reports current values instead of the
    # zeros the end-of-run()-only sync used to leave behind
    _sync_hook: Optional[Callable[[], None]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _sync_external(self) -> None:
        if self._sync_hook is not None:
            self._sync_hook()

    def advance(self, t: float) -> None:
        dt = t - self._last_t
        if dt > 0:
            self.util_node_seconds += dt * self._occupied
            self.healthy_node_seconds += dt * self._healthy
            self._last_t = t

    def set_occupancy(self, occupied: int, healthy: int) -> None:
        self._occupied = occupied
        self._healthy = healthy

    @property
    def utilization(self) -> float:
        if self.healthy_node_seconds <= 0:
            return 0.0
        return self.util_node_seconds / self.healthy_node_seconds

    def mean_queueing_delay(self, tier: Optional[int] = None) -> float:
        """Mean submit->first-placement delay, optionally for one SLO tier."""
        delays = [
            r.queueing_delay for r in self.records.values()
            if r.queueing_delay is not None
            and (tier is None or r.job.tier == tier)
        ]
        return sum(delays) / len(delays) if delays else 0.0

    def mean_goodput(self) -> float:
        """Mean per-job goodput, each job work-weighted over its run
        segments (a migrated/shrunk job no longer reports only its final
        segment's goodput)."""
        g = [
            r.weighted_goodput() for r in self.records.values()
            if r.start_t is not None
        ]
        return sum(g) / len(g) if g else 0.0

    def policy_summary(self) -> Dict[str, object]:
        """Policy-engine figures (separate from :meth:`summary` so the
        default-trace summary keys stay exactly the seed set)."""
        self._sync_external()
        tiers = sorted({r.job.tier for r in self.records.values()})
        return {
            "preemptions": self.preemptions,
            "expansions": self.expansions,
            "run_segments": sum(r.segment_count for r in self.records.values()),
            "queue_delay_by_tier": {
                t: round(self.mean_queueing_delay(tier=t), 3) for t in tiers
            },
            "finished_by_tier": {
                t: sum(
                    1 for r in self.records.values()
                    if r.job.tier == t and r.finish_t is not None
                )
                for t in tiers
            },
        }

    def survivability_summary(self) -> Dict[str, object]:
        """Failure-response figures (separate from :meth:`summary` for the
        same reason as :meth:`policy_summary`): fault counts per domain,
        the repair-vs-ladder split, checkpoint work lost, observed mean
        time-to-restore, and goodput under failure relative to fault-free
        (the work-weighted mean degradation factor of repaired segments —
        1.0 when nothing ever ran degraded)."""
        self._sync_external()
        return {
            "node_faults": self.node_faults,
            "switch_faults": self.switch_faults,
            "link_faults": self.link_faults,
            "repairs": self.repairs,
            "repair_fallbacks": self.repair_fallbacks,
            "partial_migrations": self.partial_migrations,
            "lost_work_s": round(self.lost_work_s, 3),
            "mean_mttr_s": round(
                self.mttr_total_s / self.mttr_count, 3
            ) if self.mttr_count else 0.0,
            "quarantines": self.quarantines,
            "degraded_work_s": round(self.degraded_work_s, 3),
            "goodput_under_failure_ratio": round(
                self.degraded_factor_work_s / self.degraded_work_s, 4
            ) if self.degraded_work_s > 0 else 1.0,
            "txn_commits": self.txn_commits,
            "txn_retries": self.txn_retries,
            "txn_retry_strokes": self.txn_retry_strokes,
            "txn_rollbacks": self.txn_rollbacks,
            "txn_rollback_strokes": self.txn_rollback_strokes,
        }

    def serving_summary(self) -> Dict[str, object]:
        """Serving-twin counters (separate from :meth:`summary` for the
        same reason as :meth:`policy_summary`; the queue/SLO figures live
        on the scheduler's per-service state, not here)."""
        self._sync_external()
        return {
            "replica_scale_events": self.replica_scale_events,
            "scale_ups": self.serving_scale_ups,
            "scale_downs": self.serving_scale_downs,
            "scale_failures": self.serving_scale_failures,
            "serving_preemptions": self.serving_preemptions,
            "serving_repairs": self.serving_repairs,
            "serving_migrations": self.serving_migrations,
            "serving_fault_evictions": self.serving_fault_evictions,
        }

    def summary(self) -> Dict[str, float]:
        self._sync_external()
        finished = sum(1 for r in self.records.values() if r.finish_t is not None)
        return {
            "jobs": len(self.records),
            "finished": finished,
            "events": self.events_processed,
            "utilization": round(self.utilization, 4),
            "mean_queue_delay_s": round(self.mean_queueing_delay(), 3),
            "mean_goodput": round(self.mean_goodput(), 4),
            "reconfig_rounds": self.reconfig_rounds,
            "circuits_flipped": self.circuits_flipped,
            "reconfig_downtime_s": round(self.total_downtime_s, 4),
            "placement_attempts": self.placement_attempts,
            "placement_scans": self.placement_scans,
            "circuit_cache_hits": self.circuit_cache_hits,
            "circuit_cache_misses": self.circuit_cache_misses,
            "goodput_cache_hits": self.goodput_cache_hits,
            "goodput_cache_misses": self.goodput_cache_misses,
        }
