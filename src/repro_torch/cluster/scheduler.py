"""MLaaS cluster scheduler for a RailX installation (paper §6.6, §7).

The port's own copy of ``repro/cluster/scheduler.py``.  It imports nothing
of ``repro``.  Its one device is the goodput's: ``device`` (the card unless
the caller passes ``"cpu"``) is resolved once, at construction, through
``device.resolve``, and handed to the ``GoodputCache``, whose misses route
the job's traffic there through the flow kernels.  The scheduling itself is
plain Python, and every decision and figure is the reference's.

Discrete-event loop over job-submit / job-finish / node-fail /
node-recover events.  The scheduler owns:

* the node grid (side = R/2 by default) with its fault set, mirrored in
  an incrementally-maintained ``OccupancyIndex`` (per-row bitmasks,
  O(footprint) updates) that the placement policies operate on;
* the global OCS circuit state, updated through ``reconfig`` patch plans
  whose downtime is charged to the affected jobs' timelines.  Installs
  and uninstalls diff only the switch keys a job's target touches and
  maintain per-switch circuit refcounts, so neither pays for the size of
  the whole fabric;
* a tier-aware backlog (``backlog.TieredBacklog``) served by a pluggable
  placement policy, with a free-capacity watermark per backlogged job: a
  job is only re-attempted once the free set has changed since its last
  failed attempt (the policies are deterministic, so an unchanged free
  set is a guaranteed re-failure).  With a single tier (the default) the
  backlog is exactly the seed's FIFO list.

Failure handling (§6.6) — the **recovery ladder**.  A fault touching a
running job walks the rungs in order until one succeeds; each rung is
strictly cheaper in mirror strokes / lost work than the next:

1. **repair** (``circuit_repair=True``, the default; switch/link faults
   only) — re-synthesize the job's circuits over the surviving rails in
   place (``faults.synthesize_degraded``), patched as a minimal
   per-switch diff; the job keeps its nodes at degraded goodput;
2. **partial-migrate** (``partial_migration=True``, off by default) —
   when repair is impossible (or its transaction aborted), move *only*
   the rows/columns whose rails died (``faults.irreparable_lines`` +
   ``placement.partial_refit``), keeping the surviving lines and their
   circuits pinned; checkpoint-lossy like any failure-driven move;
3. **migrate** (always on) — full-size re-placement on the surviving
   free nodes (checkpoint-restore move; full reconfiguration cost);
4. **shrink** (always on; bounded by ``job.min_nodes``) — elastic
   restart with the FFN/expert data-parallel degree halved (the
   ``launch/elastic`` recovery semantics);
5. **requeue** (always on) — back to the backlog with remaining work.

Node faults enter at rung 3 (their eviction is unavoidable); switch and
link faults enter at rung 1.  With ``ocs_txn=TxnConfig(...)`` every
install/repatch is a two-phase transaction whose per-switch strokes can
fail (seeded injection): a retry-exhausted transaction rolls the circuit
state back to the last consistent set and the job demotes to the next
rung instead of running on corrupted circuits.

Serving replicas (``serving=ServingConfig(...)``, the MLaaS digital
twin) traverse the same ladder with serving semantics: rungs 1-2
(repair in place, and the heal pass after a restore) re-synthesize a
replica's circuits over the surviving rails and scale the
``serving.ServiceModel``'s inter-node bandwidth term by the resulting
rail factor — a partially-migrated or repaired replica decodes slower
instead of running at degraded goodput, which the per-service M/M/c
queue turns into queue delay and missed SLOs.  An irreparable fault
evicts the replica and attempts an immediate full-size re-place (rung
3, migrate).  Where a training job would *shrink*, a service maps the
rung to **replica scale-down**: it simply runs one replica short (no
elastic re-plan — replicas are fixed shapes), and the autoscaler, when
enabled, re-emits the target count at the next rate sample once
capacity returns — the serving analog of requeue.

Policy engine (§6.6, §7 MLaaS operation; all off by default, in which
case scheduling is byte-identical to the plain FIFO scheduler):

* **preemption** (``preemption=True``) — a submit-time placement failure
  for a tier-t job may checkpoint-evict a minimal, deterministically
  chosen set of strictly-lower-tier running jobs (cheapest first: lowest
  tier, least remaining work x footprint); victims requeue at the front
  of their own tier with their remaining work.
* **gang scoring** (``gang_scoring=True``) — placement prefers
  rectangles whose rows/columns share OCS switch groups already holding
  circuits (``placement.gang_scored_fit``), and circuit teardown becomes
  lazy: a departing job's circuits stay programmed as *orphans* (zero
  mirror strokes) until a later install either reuses them verbatim
  (zero-flip placement for repeat shapes) or evicts the ones whose ports
  it needs.  Global per-switch port discipline is preserved — orphans
  conflicting with a new target are removed in the same patch.
* **re-expansion** (``re_expansion=True``) — after a ``JobFinish`` or
  ``NodeRecover`` frees capacity, shrunken jobs are grown back toward
  their submit-time plan (inverting the shrink ladder, largest step that
  fits first) with remaining work re-compressed by the worker ratio.
* **serving** (``serving=ServingConfig(...)``) — latency-SLO inference
  services placed as replicas through the same machinery, driven by
  ``RateUpdate`` samples from the diurnal trace generator.  The
  autoscaler (``autoscale=True``) emits ``ReplicaScale`` events sized
  to the per-replica roofline rate; ``preempt_training=True`` lets a
  failed replica placement evict strictly-lower-tier training jobs,
  and ``headroom_nodes`` reserves free nodes that training placements
  may not consume.  ``serving=None`` (the default) keeps zero serving
  state and byte-identical scheduling.

Goodput: each placed job's Table-4 traffic is routed through
``core.simulator``'s flow model on the job's reconfigured rail network;
service time stretches by 1/goodput.  Circuit targets and goodput are
memoized by (mapping, allocation shape) — see ``reconfig.CircuitShapeCache``
and ``metrics.GoodputCache`` — so repeat placements of the same job shape
cost one coordinate relabel instead of a fresh ring synthesis + routing.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, FrozenSet, Iterable, List, Literal, Optional, Set, Tuple

from .. import device as _device
from ..core.availability import JobAllocation
from ..core.mapping import ParallelismPlan
from ..core.topology import RailXConfig
from ..obs import MetricsRegistry, get_tracer
from .events import (
    Coord,
    Event,
    EventQueue,
    JobFinish,
    JobSubmit,
    LinkFail,
    LinkRecover,
    NodeFail,
    NodeRecover,
    QuarantineRelease,
    RateUpdate,
    ReplicaScale,
    SwitchFail,
    SwitchRecover,
)
from .backlog import TieredBacklog
from .faults import (
    FlapTracker,
    LinkId,
    QuarantineConfig,
    faults_hit_target,
    irreparable_lines,
    link_hits_circuits,
    synthesize_degraded,
)
from .jobs import JobMapping, JobSpec, plan_job_mapping
from .metrics import GoodputCache, JobRecord, TimelineMetrics
from .occupancy import OccupancyIndex
from .placement import PlacementPolicy, gang_scored_fit, get_policy, partial_refit
from .reconfig import (
    Circuit,
    CircuitMap,
    CircuitShapeCache,
    ReconfigCostModel,
    ReconfigPlan,
    SwitchKey,
    SwitchPatch,
    TxnConfig,
    _check_port_discipline,
)
from .serving import (
    Replica,
    ServiceState,
    ServingConfig,
    desired_replicas,
)


@dataclasses.dataclass
class RunningJob:
    job: JobSpec
    jmap: JobMapping
    alloc: JobAllocation
    circuits: CircuitMap
    goodput: float
    remaining_work_s: float       # seconds at goodput 1.0
    resumed_t: float              # when the current run segment started
    expected_finish: float
    epoch: int = 0                # run-segment counter (JobFinish matching)
    base_goodput: float = 1.0     # fault-free goodput of this placement
    degradation: float = 1.0      # surviving-rail factor (goodput = base * this)


class _TxnAbort(Exception):
    """Internal: a per-switch stroke exhausted its retries mid-transaction
    (see ``TxnConfig``).  Never escapes the scheduler — ``_txn_run``
    catches it, rolls the circuit state back, and reports the abort."""


class _CircuitTxn:
    """Undo journal for one two-phase OCS transaction.

    ``_install``/``_uninstall`` call ``snapshot(key)`` before mutating a
    switch key's state and ``roll(patch)`` before committing a physical
    stroke to it.  ``roll`` dices the injected per-switch failure; on
    retry exhaustion it raises ``_TxnAbort`` and ``rollback`` restores
    every touched key — refcounts, live circuits, orphans, and the
    reconfig metrics triple — to its exact pre-transaction value.  The
    mirror strokes needed to physically undo the committed patches are
    accounted via ``ReconfigPlan.inverted()`` (the revert involution)."""

    def __init__(self, sched: "ClusterScheduler"):
        self.sched = sched
        m = sched.metrics
        self._metrics0 = (
            m.reconfig_rounds, m.circuits_flipped, m.total_downtime_s
        )
        # key -> (refs copy | None, live frozenset | None, orphans copy | None)
        self._saved: Dict[SwitchKey, Tuple] = {}
        self._order: List[SwitchKey] = []
        self.committed: List[SwitchPatch] = []
        self.retries = 0
        self.retry_strokes = 0
        self.backoff_s = 0.0

    def snapshot(self, key: SwitchKey) -> None:
        if key in self._saved:
            return
        s = self.sched
        refs = s._switch_refs.get(key)
        orph = s._orphans.get(key)
        self._saved[key] = (
            dict(refs) if refs is not None else None,
            s.circuits.get(key),
            set(orph) if orph is not None else None,
        )
        self._order.append(key)

    def roll(self, patch: SwitchPatch) -> None:
        """Dice the physical stroke for one patched switch; each failed
        attempt charges its strokes and an exponential backoff, and the
        (max_retries+1)-th consecutive failure aborts the transaction."""
        cfgt = self.sched.ocs_txn
        rng = self.sched._txn_rng
        attempt = 0
        while rng.random() < cfgt.apply_failure_rate:
            if attempt >= cfgt.max_retries:
                raise _TxnAbort()
            self.retries += 1
            self.retry_strokes += patch.flips
            self.backoff_s += (
                cfgt.backoff_base_s * cfgt.backoff_factor ** attempt
            )
            attempt += 1
        self.committed.append(patch)

    def rollback(self) -> None:
        s = self.sched
        for key in reversed(self._order):
            refs, live, orph = self._saved[key]
            if refs is None:
                s._switch_refs.pop(key, None)
            else:
                s._switch_refs[key] = refs
            if orph is None:
                s._orphans.pop(key, None)
            else:
                s._orphans[key] = orph
            if live is None:
                if s.circuits.pop(key, None) is not None:
                    s._line_sub(key)
            else:
                if key not in s.circuits:
                    s._line_add(key)
                s.circuits[key] = live
        m = s.metrics
        (m.reconfig_rounds, m.circuits_flipped, m.total_downtime_s) = (
            self._metrics0
        )


def _event_trace_args(ev: Event) -> Dict[str, object]:
    """Trace-span args for one scheduler event (traced path only)."""
    args: Dict[str, object] = {"sim_t": ev.time}
    if isinstance(ev, JobSubmit):
        args["job"] = ev.job.job_id
    elif isinstance(ev, JobFinish):
        args["job"] = ev.job_id
        args["epoch"] = ev.epoch
    elif isinstance(ev, (NodeFail, NodeRecover)):
        args["node"] = list(ev.node)
    elif isinstance(ev, (SwitchFail, SwitchRecover)):
        args["switch"] = list(ev.switch)
    elif isinstance(ev, (LinkFail, LinkRecover)):
        args["node"] = list(ev.node)
        args["dim"] = ev.dim
        args["rail"] = ev.rail
    elif isinstance(ev, QuarantineRelease):
        args["kind"] = ev.kind
        if ev.node is not None:
            args["node"] = list(ev.node)
        if ev.switch is not None:
            args["switch"] = list(ev.switch)
        if ev.link is not None:
            args["node"] = list(ev.link[0])
            args["dim"] = ev.link[1]
            args["rail"] = ev.link[2]
    elif isinstance(ev, RateUpdate):
        args["service"] = ev.service_id
        args["rate_rps"] = ev.rate_rps
    elif isinstance(ev, ReplicaScale):
        args["service"] = ev.service_id
        args["target"] = ev.target_replicas
        args["reason"] = ev.reason
    return args


class ClusterScheduler:
    """Deterministic discrete-event MLaaS scheduler."""

    def __init__(
        self,
        cfg: RailXConfig,
        n: Optional[int] = None,
        policy: str = "best_fit",
        cost_model: Optional[ReconfigCostModel] = None,
        goodput_model: Literal["flow", "none"] = "flow",
        # invariant checking, not behavior: validation never alters
        # scheduling decisions, only raises on bugs
        # lint: allow[flag-default-on]
        validate_circuits: bool = True,
        preemption: bool = False,
        gang_scoring: bool = False,
        re_expansion: bool = False,
        tracer=None,
        registry: Optional[MetricsRegistry] = None,
        fabric: str = "railx-hyperx",
        # inert without fault events: the repair rung only runs when a
        # failure record arrives
        # lint: allow[flag-default-on]
        circuit_repair: bool = True,
        checkpoint_interval_s: Optional[float] = None,
        quarantine: Optional[QuarantineConfig] = None,
        ocs_txn: Optional[TxnConfig] = None,
        partial_migration: bool = False,
        serving: Optional[ServingConfig] = None,
        device=None,
    ):
        self.cfg = cfg
        # the goodput's device, resolved once: the card unless the caller
        # passes "cpu" (raises without a card)
        self.device = _device.resolve(device)
        self.n = n if n is not None else cfg.nodes_per_side
        if self.n > cfg.nodes_per_side:
            raise ValueError(
                f"grid side {self.n} exceeds R/2={cfg.nodes_per_side}"
            )
        self.policy_name = policy
        self.policy: PlacementPolicy = get_policy(policy)
        self.cost_model = cost_model or ReconfigCostModel()
        self.goodput_model = goodput_model
        self.validate_circuits = validate_circuits
        self.preemption = preemption
        self.gang_scoring = gang_scoring
        self.re_expansion = re_expansion
        self.fabric = fabric
        # failure-aware recovery.  ``circuit_repair`` only acts
        # on SwitchFail/LinkFail events — default traces contain none, so
        # the default-on setting cannot perturb seed scheduling.  The
        # checkpoint loss model and flap quarantine are off unless
        # configured.
        self.circuit_repair = circuit_repair
        self.checkpoint_interval_s = checkpoint_interval_s
        self.quarantine = quarantine
        self._flaps: Optional[FlapTracker] = (
            FlapTracker(quarantine) if quarantine is not None else None
        )
        # transactional OCS apply + partial migration.  With
        # ``ocs_txn=None`` installs stay on the direct (atomic) path and
        # scheduling is byte-identical to the non-transactional scheduler;
        # a TxnConfig with apply_failure_rate=0.0 commits every stroke
        # first try with zero extra downtime, so only injected failures
        # can perturb timelines (fingerprint-tested).
        self.ocs_txn = ocs_txn
        self._txn_rng: Optional[random.Random] = (
            random.Random(ocs_txn.seed ^ 0x0C51F7)
            if ocs_txn is not None else None
        )
        self._active_txn: Optional[_CircuitTxn] = None
        self.partial_migration = partial_migration
        self.failed_switches: Set[SwitchKey] = set()
        self.failed_links: Set[LinkId] = set()
        self._down_since: Dict[object, float] = {}   # entity -> fail time

        self.faults: Set[Coord] = set()
        self.running: Dict[int, RunningJob] = {}
        self.backlog = TieredBacklog()
        self.circuits: CircuitMap = {}
        self.metrics = TimelineMetrics(grid_nodes=self.n * self.n)
        self._queue = EventQueue()
        self._jmap_cache: Dict[int, JobMapping] = {}
        # §5 mapping-solver memo keyed by (arch, plan, shape): the solver
        # is a pure function of those, so the expansion/shrink ladders'
        # repeated candidate probes cost a dict hit instead of a re-solve
        self._solver_cache: Dict[Tuple[object, object, object], JobMapping] = {}
        # observability: one registry backs every cache counter; the tracer
        # defaults to the ambient one (NULL_TRACER unless a ``tracing``
        # block is active), so instrumentation is free when disabled
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self._solver_hits = self.registry.counter("mapping_solver.hits")
        self._solver_misses = self.registry.counter("mapping_solver.misses")
        self._occ = OccupancyIndex(self.n)
        self._circuit_cache = CircuitShapeCache(
            cfg, validate=validate_circuits, registry=self.registry
        )
        self._goodput_cache = GoodputCache(
            cfg, registry=self.registry, fabric=fabric, device=self.device
        )
        # keep mid-run summaries honest: summary()/policy_summary() pull the
        # live cache counters instead of whatever the last run() left behind
        self.metrics._sync_hook = self._sync_cache_stats
        # per-switch circuit refcounts: uninstall removes a circuit only
        # when its last owner releases it (jobs on disjoint rectangles use
        # disjoint ports, so counts stay at 1 in practice — the refcount
        # keeps the diff local either way)
        self._switch_refs: Dict[SwitchKey, Dict[Circuit, int]] = {}
        # backlog watermark: job_id -> occupancy version at last failed
        # placement attempt; unchanged version => guaranteed re-failure
        self._backlog_seen: Dict[int, int] = {}
        self._segment: Dict[int, int] = {}     # job_id -> run-segment epoch
        # submit-time spec per job (re-expansion inverts the shrink ladder
        # back toward this plan)
        self._orig_spec: Dict[int, JobSpec] = {}
        # gang mode: circuits still programmed but owned by no job (lazy
        # teardown); a later install reuses or evicts them per-port
        self._orphans: Dict[SwitchKey, Set[Circuit]] = {}
        # programmed-switch counts per row (X groups) / column (Y groups),
        # maintained at the exact points keys enter/leave self.circuits so
        # gang scans never walk the whole (monotonically growing) map
        self._line_rows: Dict[int, int] = {}
        self._line_cols: Dict[int, int] = {}
        # occupied-node counter maintained at place/evict/finish, with a
        # dirty flag so the per-event metrics sync is O(1) instead of an
        # O(#running-jobs) walk (the walk is kept as
        # ``recount_occupied_nodes`` for the equivalence tests)
        self._occupied_count = 0
        self._occ_dirty = True
        # MLaaS serving digital twin.  ``serving=None`` (the
        # default) keeps ``self.services`` empty and every serving hook a
        # no-op, so flags-off scheduling is byte-identical (fingerprint
        # tested).  Initial replicas are placed at t=0, before any events.
        self.serving = serving
        self.services: Dict[int, ServiceState] = {}
        self._service_pseudo: Dict[int, JobSpec] = {}
        self._serving_headroom = (
            serving.headroom_nodes if serving is not None else 0
        )
        if serving is not None:
            for spec in serving.services:
                if spec.service_id in self.services:
                    raise ValueError(f"duplicate service_id {spec.service_id}")
                st = ServiceState(spec=spec, model=serving.model_for(spec))
                self.services[spec.service_id] = st
                self._service_pseudo[spec.service_id] = spec.to_job_spec()
                for _ in range(spec.initial_replicas):
                    if not self._place_replica(st, 0.0):
                        st.scale_failures += 1
                        self.metrics.serving_scale_failures += 1
                        break
                st.mark_replicas(0.0)

    # -- state helpers ------------------------------------------------------

    def free_nodes(self) -> Set[Coord]:
        """Materialized free set (kept for inspection/tests; the hot path
        uses ``self._occ`` directly)."""
        return self._occ.free_set()

    def occupied_nodes(self) -> int:
        return self._occupied_count

    def recount_occupied_nodes(self) -> int:
        """O(#running-jobs) recomputation (tests / debugging only)."""
        return sum(rj.alloc.size for rj in self.running.values())

    def healthy_nodes(self) -> int:
        return self.n * self.n - len(self.faults)

    def _sync_occupancy(self) -> None:
        if self._occ_dirty:
            self.metrics.set_occupancy(self._occupied_count, self.healthy_nodes())
            if self.tracer.enabled:
                # Perfetto counter track: utilization over simulated events
                self.tracer.counter(
                    "occupancy",
                    occupied=self._occupied_count,
                    healthy=self.healthy_nodes(),
                )
            self._occ_dirty = False

    def _job_mapping(self, job: JobSpec) -> JobMapping:
        if job.job_id not in self._jmap_cache:
            self._jmap_cache[job.job_id] = self._solve_mapping(job)
        return self._jmap_cache[job.job_id]

    def _solve_mapping(self, job: JobSpec) -> JobMapping:
        """Memoized ``plan_job_mapping``: identical (arch, plan, shape)
        triples — e.g. every candidate rung of the re-expansion ladder,
        re-probed after each capacity-freeing event — solve once."""
        key = (job.arch, job.plan, job.shape)
        jmap = self._solver_cache.get(key)
        if jmap is None:
            self._solver_misses.inc()
            jmap = plan_job_mapping(self.cfg, job)
            self._solver_cache[key] = jmap
        else:
            self._solver_hits.inc()
        return jmap

    @property
    def mapping_solver_hits(self) -> int:
        """Legacy view of the ``mapping_solver.hits`` registry counter."""
        return self._solver_hits.value

    @property
    def mapping_solver_misses(self) -> int:
        """Legacy view of the ``mapping_solver.misses`` registry counter."""
        return self._solver_misses.value

    def _sync_cache_stats(self) -> None:
        self.metrics.circuit_cache_hits = self._circuit_cache.hits
        self.metrics.circuit_cache_misses = self._circuit_cache.misses
        self.metrics.goodput_cache_hits = self._goodput_cache.hits
        self.metrics.goodput_cache_misses = self._goodput_cache.misses

    # -- reconfiguration ----------------------------------------------------

    def _account(self, plan: ReconfigPlan) -> float:
        dt = self.cost_model.downtime(plan)
        if plan.patches:
            self.metrics.reconfig_rounds += 1
            self.metrics.circuits_flipped += plan.circuits_flipped
            self.metrics.total_downtime_s += dt
        return dt

    def _install(self, target: CircuitMap) -> Tuple[ReconfigPlan, float]:
        """Patch the global circuit state to include ``target``; returns the
        plan and its downtime.  Touches only the switch keys in ``target``.

        In gang mode a switch may hold *orphan* circuits (lazily retained
        from departed jobs).  Orphans matching the target are reused with
        zero flips; orphans holding a port the target needs are evicted in
        the same patch, so per-switch port discipline always holds for the
        union of live and orphan circuits.
        """
        trc = self.tracer
        if trc.enabled:
            trc.begin("ocs.apply", cat="ocs", switches=len(target))
        txn = self._active_txn
        patches: List[SwitchPatch] = []
        try:
            for key in sorted(target):
                if txn is not None:
                    txn.snapshot(key)
                tgt = target[key]
                refs = self._switch_refs.setdefault(key, {})
                for c in tgt:
                    refs[c] = refs.get(c, 0) + 1
                cur = self.circuits.get(key, frozenset())
                remove: FrozenSet[Circuit] = frozenset()
                orphans = self._orphans.get(key)
                if orphans:
                    orphans -= tgt                  # reused verbatim: now live
                    out_ports = {pa for pa, _ in tgt}
                    in_ports = {pb for _, pb in tgt}
                    conflict = {
                        c for c in orphans
                        if c[0] in out_ports or c[1] in in_ports
                    }
                    if conflict:
                        orphans -= conflict
                        remove = frozenset(conflict)
                        cur = cur - remove
                    if not orphans:
                        del self._orphans[key]
                add = tgt - cur
                if add or remove:
                    patch = SwitchPatch(key, remove=remove, add=add)
                    if txn is not None:
                        txn.roll(patch)   # may abort before the key mutates
                    patches.append(patch)
                    new = cur | add
                    if new:
                        if key not in self.circuits:
                            self._line_add(key)
                        self.circuits[key] = new
                    else:  # pragma: no cover - remove implies a prior add
                        if self.circuits.pop(key, None) is not None:
                            self._line_sub(key)
        except _TxnAbort:
            if trc.enabled:
                trc.end("ocs.apply", patched=len(patches), aborted=True)
            raise
        plan = ReconfigPlan(tuple(patches))
        dt = self._account(plan)
        if trc.enabled:
            trc.end(
                "ocs.apply",
                patched=len(plan.patches),
                strokes=plan.circuits_flipped,
                downtime_s=dt,
            )
        return plan, dt

    def _uninstall(self, target: CircuitMap) -> Tuple[ReconfigPlan, float]:
        trc = self.tracer
        if trc.enabled:
            trc.begin("ocs.revert", cat="ocs", switches=len(target))
        lazy = self.gang_scoring
        txn = self._active_txn
        patches: List[SwitchPatch] = []
        try:
            for key in sorted(target):
                if txn is not None:
                    txn.snapshot(key)
                tgt = target[key]
                refs = self._switch_refs.setdefault(key, {})
                dead = set()
                for c in tgt:
                    left = refs.get(c, 0) - 1
                    if left > 0:
                        refs[c] = left
                    else:
                        refs.pop(c, None)
                        dead.add(c)
                if not refs:
                    del self._switch_refs[key]
                cur = self.circuits.get(key, frozenset())
                remove = cur & frozenset(dead)
                if not remove:
                    continue
                if key in self.failed_switches:
                    # the switch is physically dead: its circuits are already
                    # gone, so releasing them is free (no mirror stroke) and
                    # orphaning them would be fiction
                    left_circuits = cur - remove
                    if left_circuits:
                        self.circuits[key] = left_circuits
                    elif self.circuits.pop(key, None) is not None:
                        self._line_sub(key)
                elif lazy:
                    # leave the circuits programmed (no mirror strokes now);
                    # track them as orphans for later reuse or eviction
                    self._orphans.setdefault(key, set()).update(remove)
                else:
                    patch = SwitchPatch(key, remove=remove, add=frozenset())
                    if txn is not None:
                        txn.roll(patch)   # may abort before the key mutates
                    patches.append(patch)
                    left_circuits = cur - remove
                    if left_circuits:
                        self.circuits[key] = left_circuits
                    elif self.circuits.pop(key, None) is not None:
                        self._line_sub(key)
        except _TxnAbort:
            if trc.enabled:
                trc.end("ocs.revert", patched=len(patches), aborted=True)
            raise
        plan = ReconfigPlan(tuple(patches))
        dt = self._account(plan)
        if trc.enabled:
            trc.end(
                "ocs.revert",
                patched=len(plan.patches),
                strokes=plan.circuits_flipped,
                downtime_s=dt,
            )
        return plan, dt

    def _txn_run(self, op: str, fn):
        """Run ``fn`` (a closure over ``_install``/``_uninstall`` calls) as
        one two-phase OCS transaction.  Returns ``(fn result, backoff_s)``
        on commit — the backoff is the extra downtime accrued by retried
        strokes, which the caller adds to the plan downtime — or ``None``
        on abort, after rolling every touched switch back to its exact
        pre-transaction state and charging the rollback mirror strokes."""
        trc = self.tracer
        txn = _CircuitTxn(self)
        self._active_txn = txn
        if trc.enabled:
            trc.begin("ocs.txn_apply", cat="ocs", op=op)
        try:
            result = fn()
        except _TxnAbort:
            self._active_txn = None
            rb_plan = ReconfigPlan(tuple(txn.committed)).inverted()
            if trc.enabled:
                with trc.span(
                    "ocs.txn_rollback", cat="ocs", op=op,
                    patched=len(rb_plan.patches),
                    strokes=rb_plan.circuits_flipped,
                ):
                    txn.rollback()
            else:
                txn.rollback()
            # undoing the committed patches is itself a reconfiguration
            # round: charge its strokes and downtime on top of the backoff
            # already paid on the failed retries
            rb_dt = self.cost_model.downtime(rb_plan) if rb_plan.patches else 0.0
            m = self.metrics
            m.txn_rollbacks += 1
            m.txn_retries += txn.retries
            m.txn_retry_strokes += txn.retry_strokes
            m.txn_rollback_strokes += rb_plan.circuits_flipped
            if rb_plan.patches:
                m.reconfig_rounds += 1
                m.circuits_flipped += rb_plan.circuits_flipped
            m.total_downtime_s += txn.backoff_s + rb_dt
            if trc.enabled:
                trc.end(
                    "ocs.txn_apply", committed=False, retries=txn.retries
                )
            return None
        self._active_txn = None
        m = self.metrics
        m.txn_commits += 1
        m.txn_retries += txn.retries
        m.txn_retry_strokes += txn.retry_strokes
        m.total_downtime_s += txn.backoff_s
        if trc.enabled:
            trc.end("ocs.txn_apply", committed=True, retries=txn.retries)
        return result, txn.backoff_s

    def _install_checked(
        self, target: CircuitMap
    ) -> Optional[Tuple[ReconfigPlan, float]]:
        """``_install``, transactionally when ``ocs_txn`` is configured:
        returns the (plan, downtime-including-backoff) pair, or ``None``
        when the transaction aborted and the circuit state was rolled
        back (the caller demotes — e.g. a placement fails and the job
        backlogs for the next capacity event)."""
        if self.ocs_txn is None:
            return self._install(target)
        res = self._txn_run("install", lambda: self._install(target))
        if res is None:
            return None
        (plan, dt), backoff = res
        return plan, dt + backoff

    # -- placement ----------------------------------------------------------

    def _line_add(self, key: SwitchKey) -> None:
        dim, group, _rail = key
        w = self._line_rows if dim == "X" else self._line_cols
        w[group] = w.get(group, 0) + 1

    def _line_sub(self, key: SwitchKey) -> None:
        dim, group, _rail = key
        w = self._line_rows if dim == "X" else self._line_cols
        left = w.get(group, 0) - 1
        if left > 0:
            w[group] = left
        else:
            w.pop(group, None)

    def _line_weights(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        """Programmed-switch counts per row (X groups) and column (Y
        groups) — the gang-affinity signal.  Includes orphans: in gang
        mode those are exactly the lines where a repeat shape can land
        for free."""
        return self._line_rows, self._line_cols

    def _scan_policy(
        self, occ: OccupancyIndex, jmap: JobMapping
    ) -> Optional[JobAllocation]:
        """One policy scan on ``occ`` (the live index or a trial clone) —
        the single place that decides between the configured policy and
        gang-affinity scoring, so trial placements (preemption,
        re-expansion) see exactly what the real placement will do."""
        if self.gang_scoring:
            rw, cw = self._line_weights()
            return gang_scored_fit(
                self.n, occ, jmap.rows_req, jmap.cols_req, rw, cw
            )
        return self.policy(self.n, occ, jmap.rows_req, jmap.cols_req)

    def _try_place(
        self, job: JobSpec, t: float, jmap: Optional[JobMapping] = None,
        remaining_work_s: Optional[float] = None,
    ) -> bool:
        jmap = jmap or self._job_mapping(job)
        trc = self.tracer
        if not trc.enabled:
            return self._place(job, t, jmap, remaining_work_s)
        with trc.span(
            "placement.attempt",
            cat="scheduler",
            job=job.job_id,
            rows_req=jmap.rows_req,
            cols_req=jmap.cols_req,
            candidate_rows=sum(
                1 for r in range(self.n)
                if bin(self._occ.free_row(r)).count("1") >= jmap.cols_req
            ),
        ) as sp:
            placed = self._place(job, t, jmap, remaining_work_s)
            sp.set(placed=placed)
            return placed

    def _place(
        self, job: JobSpec, t: float, jmap: JobMapping,
        remaining_work_s: Optional[float],
    ) -> bool:
        self.metrics.placement_attempts += 1
        if self._serving_headroom > 0:
            # SLO policy: reserve headroom nodes for serving scale-ups —
            # a training placement may not eat into the reserve (serving
            # placements go through _do_place_replica, which skips this)
            if self._occ.free_count - jmap.nodes < self._serving_headroom:
                return False
        if jmap.nodes > self.n * self.n:
            return False
        if not self._occ.can_fit(jmap.rows_req, jmap.cols_req):
            # O(n) necessary condition (enough rows with enough free cells)
            # — skip the policy scan when no rectangle can possibly exist
            return False
        self.metrics.placement_scans += 1
        alloc = self._scan_policy(self._occ, jmap)
        if alloc is None:
            return False
        trc = self.tracer
        if trc.enabled:
            with trc.span("ocs.synthesize", cat="ocs", job=job.job_id):
                target = self._circuit_cache.target_for(jmap.mapping, alloc)
        else:
            target = self._circuit_cache.target_for(jmap.mapping, alloc)
        factor = 1.0
        if self.circuit_repair and (self.failed_switches or self.failed_links):
            # a fresh placement must not program circuits onto dead
            # hardware: re-synthesize over the surviving rails (the
            # rectangle the policy chose is kept; an irreparable fault
            # set fails the attempt and the job backlogs)
            if faults_hit_target(
                target, self.failed_switches, self.failed_links
            ):
                res = synthesize_degraded(
                    self.cfg, jmap.mapping, alloc,
                    frozenset(self.failed_switches),
                    frozenset(self.failed_links),
                )
                if res is None:
                    return False
                target, factor = res
        inst = self._install_checked(target)
        if inst is None:
            # install transaction aborted: circuits rolled back to the
            # pre-attempt state, the placement fails, and the job demotes
            # (backlog, or the caller's next recovery-ladder rung)
            return False
        _, downtime = inst
        if self.goodput_model == "flow":
            if trc.enabled:
                with trc.span("goodput.estimate", cat="flow", job=job.job_id) as gsp:
                    base_g = self._goodput_cache.goodput_for(job, jmap.mapping, alloc)
                    gsp.set(goodput=base_g)
            else:
                base_g = self._goodput_cache.goodput_for(job, jmap.mapping, alloc)
        else:
            base_g = 1.0
        g = base_g * factor
        work = job.service_s if remaining_work_s is None else remaining_work_s
        finish = t + downtime + work / g
        epoch = self._segment.get(job.job_id, 0) + 1
        self._segment[job.job_id] = epoch
        self._occ.occupy(alloc.rows, alloc.cols)
        self._occupied_count += alloc.size
        self._occ_dirty = True
        self.running[job.job_id] = RunningJob(
            job=job, jmap=jmap, alloc=alloc, circuits=target,
            goodput=g, remaining_work_s=work, resumed_t=t + downtime,
            expected_finish=finish, epoch=epoch,
            base_goodput=base_g, degradation=factor,
        )
        rec = self.metrics.records[job.job_id]
        if rec.start_t is None:
            rec.start_t = t
        rec.nodes = alloc.size
        rec.goodput = g
        rec.reconfig_downtime_s += downtime
        self._queue.push(JobFinish(time=finish, job_id=job.job_id, epoch=epoch))
        return True

    def _drain_backlog(self, t: float) -> None:
        trc = self.tracer
        if not trc.enabled:
            self._drain(t)
            return
        if len(self.backlog) == 0:
            return  # nothing to drain: keep the trace free of no-op spans
        with trc.span(
            "backlog.drain", cat="scheduler", backlog=len(self.backlog)
        ) as sp:
            placed = self._drain(t)
            sp.set(placed=placed, remaining=len(self.backlog))

    def _drain(self, t: float) -> int:
        placed = 0
        placed_any = True
        while placed_any:
            placed_any = False
            for job in self.backlog.jobs():   # tier desc, FIFO within
                seen = self._backlog_seen.get(job.job_id)
                if seen is not None and seen == self._occ.version:
                    continue  # free set identical to the last failure
                if self._try_place(job, t):
                    self.backlog.remove(job)
                    self._backlog_seen.pop(job.job_id, None)
                    placed_any = True
                    placed += 1
                else:
                    self._backlog_seen[job.job_id] = self._occ.version
        return placed

    # -- preemption ---------------------------------------------------------

    def _preemption_cost(self, rj: RunningJob, t: float) -> Tuple:
        """Deterministic victim ordering: lowest tier first, then least
        invested (remaining work x footprint — evicting a nearly-idle or
        tiny job disturbs the least), then job id."""
        elapsed = max(0.0, t - rj.resumed_t)
        remaining = max(0.0, rj.remaining_work_s - elapsed * rj.goodput)
        return (rj.job.tier, remaining * rj.alloc.size, rj.job.job_id)

    def select_victims(
        self, job: JobSpec, t: float, jmap: Optional[JobMapping] = None
    ) -> Optional[List[RunningJob]]:
        """The minimal cheapest-first victim set whose eviction lets
        ``job`` place, or None if no set of strictly-lower-tier victims
        suffices.  Pure: probes the policies on a cloned occupancy index,
        touching no scheduler state.

        Greedy: victims accrue in cost order until the placement scan
        succeeds, then a backward pass drops every victim whose eviction
        turned out unnecessary — the result is minimal (dropping any
        remaining victim makes the job unplaceable), which the property
        tests assert directly.
        """
        jmap = jmap or self._job_mapping(job)
        if jmap.nodes > self.n * self.n:
            return None
        cands = [
            rj for rj in self.running.values() if rj.job.tier < job.tier
        ]
        if not cands:
            return None
        cands.sort(key=lambda rj: self._preemption_cost(rj, t))
        trial = self._occ.clone()
        chosen: List[RunningJob] = []
        found = False
        for rj in cands:
            trial.release(rj.alloc.rows, rj.alloc.cols)
            chosen.append(rj)
            if not trial.can_fit(jmap.rows_req, jmap.cols_req):
                continue
            if self._scan_policy(trial, jmap) is not None:
                found = True
                break
        if not found:
            return None
        i = len(chosen) - 1
        while i >= 0 and len(chosen) > 1:
            trial = self._occ.clone()
            for j, rj in enumerate(chosen):
                if j != i:
                    trial.release(rj.alloc.rows, rj.alloc.cols)
            if trial.can_fit(jmap.rows_req, jmap.cols_req) and (
                self._scan_policy(trial, jmap) is not None
            ):
                chosen.pop(i)
            i -= 1
        return chosen

    def _try_preempt(self, job: JobSpec, t: float) -> bool:
        """Evict the cheapest strictly-lower-tier victim set and place
        ``job`` in the hole; victims requeue (checkpointed: remaining
        work preserved) at the front of their own tiers."""
        jmap = self._job_mapping(job)
        trc = self.tracer
        if trc.enabled:
            with trc.span(
                "preempt.select",
                cat="scheduler",
                job=job.job_id,
                candidates=sum(
                    1 for rj in self.running.values() if rj.job.tier < job.tier
                ),
            ) as sp:
                victims = self.select_victims(job, t, jmap=jmap)
                sp.set(victims=-1 if victims is None else len(victims))
        else:
            victims = self.select_victims(job, t, jmap=jmap)
        if victims is None:
            return False
        for rj in victims:
            remaining = self._evict(rj, t)
            rec = self.metrics.records[rj.job.job_id]
            rec.preemptions += 1
            self.metrics.preemptions += 1
            requeued = dataclasses.replace(rj.job, service_s=remaining)
            self.backlog.push_front(requeued)
            # eviction changed occupancy, so no watermark: the drain below
            # may re-place a victim on the leftover free cells immediately
            self._backlog_seen.pop(rj.job.job_id, None)
        placed = self._try_place(job, t, jmap=jmap)
        assert placed, "victim set was verified on the trial index"
        self._drain_backlog(t)
        return True

    # -- re-expansion -------------------------------------------------------

    def _expansion_ladder(
        self, cur: ParallelismPlan, orig: ParallelismPlan
    ) -> List[ParallelismPlan]:
        """Plans from one step above ``cur`` up to ``orig``, inverting
        ``_shrunk_plan``'s ladder in reverse order (shrink halves dp
        first, then cp — so expansion restores cp first, then dp)."""
        plans: List[ParallelismPlan] = []
        p = cur
        while p.cp < orig.cp:
            p = dataclasses.replace(p, cp=p.cp * 2)
            plans.append(p)
        while p.dp < orig.dp:
            p = dataclasses.replace(p, dp=p.dp * 2)
            plans.append(p)
        return plans

    def _try_expand(self, rj: RunningJob, t: float) -> bool:
        """Grow one shrunken job back toward its submit-time plan,
        choosing the largest ladder step that fits (the job's own
        rectangle counts as free for the trial — expansion may re-place
        in place or move)."""
        orig = self._orig_spec.get(rj.job.job_id)
        if orig is None or rj.job.plan == orig.plan:
            return False
        for plan2 in reversed(self._expansion_ladder(rj.job.plan, orig.plan)):
            grown = dataclasses.replace(rj.job, plan=plan2)
            jmap = self._solve_mapping(grown)
            if jmap.nodes > self.n * self.n:
                continue
            trial = self._occ.clone()
            trial.release(rj.alloc.rows, rj.alloc.cols)
            if not trial.can_fit(jmap.rows_req, jmap.cols_req):
                continue
            if self._scan_policy(trial, jmap) is None:
                continue
            remaining = self._evict(rj, t)
            # remaining work was measured at the shrunken worker count;
            # more workers compress it by the exact inverse of the shrink
            # stretch, so a shrink -> expand round trip is work-neutral
            stretch = (rj.job.plan.dp * rj.job.plan.cp) / (plan2.dp * plan2.cp)
            placed = self._try_place(
                grown, t, jmap=jmap, remaining_work_s=remaining * stretch
            )
            assert placed, "expansion slot was verified on the trial index"
            self._jmap_cache[rj.job.job_id] = jmap
            rec = self.metrics.records[rj.job.job_id]
            rec.expansions += 1
            rec.job = grown
            self.metrics.expansions += 1
            return True
        return False

    def _maybe_expand(self, t: float) -> None:
        """Re-expansion sweep after a capacity-freeing event (JobFinish /
        NodeRecover).  Backlogged jobs were already offered the capacity
        (the drain runs first); shrunken running jobs then grow into what
        is left, highest tier first, re-draining after each growth since
        an expansion that moves frees its old rectangle."""
        if not self.re_expansion:
            return
        progressed = True
        while progressed:
            progressed = False
            for rj in sorted(
                self.running.values(),
                key=lambda r: (-r.job.tier, r.job.job_id),
            ):
                if self._try_expand(rj, t):
                    self._drain_backlog(t)
                    progressed = True
                    break

    # -- failure handling ---------------------------------------------------

    def _shrunk_plan(self, plan: ParallelismPlan) -> Optional[ParallelismPlan]:
        """Elastic shrink: halve the FFN/expert DP degree (launch/elastic
        recovery semantics — the DP axis absorbs node loss)."""
        if plan.dp >= 2 and plan.dp % 2 == 0:
            return dataclasses.replace(plan, dp=plan.dp // 2)
        if plan.cp >= 2 and plan.cp % 2 == 0:
            return dataclasses.replace(plan, cp=plan.cp // 2)
        return None

    def _close_segment(self, rj: RunningJob, executed: float) -> None:
        """Record a finished run segment (goodput means stay work-weighted)
        and, for degraded segments, feed the goodput-under-failure ratio."""
        self.metrics.records[rj.job.job_id].end_segment(
            rj.goodput, rj.alloc.size, executed
        )
        if rj.degradation < 1.0:
            self.metrics.degraded_work_s += executed
            self.metrics.degraded_factor_work_s += rj.degradation * executed

    def _evict(self, rj: RunningJob, t: float, lossy: bool = False) -> float:
        """Tear the job off the fabric; returns remaining work seconds.

        ``lossy`` applies the checkpoint-interval loss model to
        failure-driven evictions: only work up to the last completed
        checkpoint (every ``checkpoint_interval_s`` of segment wall time)
        survives; the rest is rolled back and charged to ``lost_work_s``.
        Voluntary evictions (preemption, expansion) checkpoint on demand
        and stay lossless, as does everything when the model is off
        (``checkpoint_interval_s=None``, the default — seed behavior
        credits all elapsed work)."""
        elapsed = max(0.0, t - rj.resumed_t)
        executed = min(rj.remaining_work_s, elapsed * rj.goodput)
        kept = executed
        interval = self.checkpoint_interval_s
        if lossy and interval is not None and interval > 0:
            kept = min(
                executed, math.floor(elapsed / interval) * interval * rj.goodput
            )
            lost = executed - kept
            if lost > 0:
                self.metrics.lost_work_s += lost
                self.metrics.records[rj.job.job_id].lost_work_s += lost
        remaining = rj.remaining_work_s - kept
        self._close_segment(rj, kept)
        self._uninstall(rj.circuits)
        self._occ.release(rj.alloc.rows, rj.alloc.cols)
        self._occupied_count -= rj.alloc.size
        self._occ_dirty = True
        del self.running[rj.job.job_id]
        return remaining

    def _handle_node_fail(self, ev: NodeFail) -> None:
        if ev.node not in self.faults:
            self.metrics.node_faults += 1
            self._down_since.setdefault(("node", ev.node), ev.time)
            if self._flaps is not None:
                self._flaps.record_fail(("node", ev.node))
        self.faults.add(ev.node)
        self._occ.fault(ev.node)
        self._occ_dirty = True                 # healthy count changed
        victim: Optional[RunningJob] = None
        for rj in self.running.values():
            if ev.node[0] in rj.alloc.rows and ev.node[1] in rj.alloc.cols:
                victim = rj
                break
        if victim is not None:
            remaining = self._evict(victim, ev.time, lossy=True)
            self._recover_ladder(victim.job, remaining, ev.time)
        if self.services:
            self._serving_node_fault(ev)

    def _recover_ladder(self, job: JobSpec, remaining: float, t: float) -> None:
        """Migrate -> shrink -> requeue for an already-evicted job (the
        shared tail of the recovery ladder; node faults enter here
        directly, switch/link faults only after in-place repair failed)."""
        rec = self.metrics.records[job.job_id]

        # 1) migrate at full size
        if self._try_place(job, t, remaining_work_s=remaining):
            rec.migrations += 1
            self._drain_backlog(t)        # eviction may have freed capacity
            return
        # 2) elastic shrink until the footprint fits (and >= min_nodes)
        plan = job.plan
        while True:
            plan2 = self._shrunk_plan(plan)
            if plan2 is None:
                break
            shrunk = dataclasses.replace(job, plan=plan2)
            jmap = self._solve_mapping(shrunk)
            if jmap.nodes < job.min_nodes:
                break
            # remaining work was measured with the original worker count:
            # stretch by the full lost ratio, not just this halving step
            stretch = (job.plan.dp * job.plan.cp) / (plan2.dp * plan2.cp)
            if self._try_place(
                shrunk, t, jmap=jmap,
                remaining_work_s=remaining * stretch,
            ):
                self._jmap_cache[job.job_id] = jmap
                rec.shrinks += 1
                rec.job = shrunk
                self._drain_backlog(t)    # shrink freed part of the rect
                return
            plan = plan2
        # 3) requeue with remaining work; the eviction freed the rest of the
        # rectangle, so offer it to the backlog immediately.  The full-size
        # migrate attempt above already failed at the current occupancy
        # version, so seed the watermark accordingly.
        requeued = dataclasses.replace(job, service_s=remaining)
        self.backlog.push_front(requeued)
        self._backlog_seen[job.job_id] = self._occ.version
        self._drain_backlog(t)

    # -- switch / link faults (circuit repair before the ladder) ------------

    def _repatch(
        self, rj: RunningJob, new_target: CircuitMap
    ) -> Optional[float]:
        """Swap a running job's circuits in place, touching only what
        changed: per switch key, release circuits the new target drops
        (free on dead switches — the hardware already dropped them) and
        program the additions.  Surviving rails keep their circuits and
        cost zero strokes, which is why in-place repair beats the
        evict-and-replace path (``bench_chaos`` records the comparison).
        Returns the summed downtime of both rounds — or ``None`` when
        ``ocs_txn`` is configured and the transaction (both legs run as
        one) aborted, leaving the job's old circuits fully intact."""
        old = rj.circuits
        removed: CircuitMap = {}
        added: CircuitMap = {}
        for key in sorted(old.keys() | new_target.keys()):
            before = old.get(key, frozenset())
            after = new_target.get(key, frozenset())
            if before - after:
                removed[key] = before - after
            if after - before:
                added[key] = after - before
        if self.ocs_txn is None:
            _, dt1 = self._uninstall(removed)
            _, dt2 = self._install(added)
            rj.circuits = new_target
            return dt1 + dt2
        res = self._txn_run(
            "repatch",
            lambda: (self._uninstall(removed), self._install(added)),
        )
        if res is None:
            return None
        ((_, dt1), (_, dt2)), backoff = res
        rj.circuits = new_target
        return dt1 + dt2 + backoff

    def _retime(self, rj: RunningJob, t: float, downtime: float, factor: float) -> None:
        """Re-time a repaired job: close the current segment with the work
        it executed, then continue the remainder at ``base_goodput *
        factor`` after the patch downtime.  The epoch bump retires the
        previously-scheduled finish (stale finishes are discarded)."""
        elapsed = max(0.0, t - rj.resumed_t)
        executed = min(rj.remaining_work_s, elapsed * rj.goodput)
        self._close_segment(rj, executed)
        rj.remaining_work_s -= executed
        g = rj.base_goodput * factor
        rj.goodput = g
        rj.degradation = factor
        rj.resumed_t = t + downtime
        epoch = self._segment.get(rj.job.job_id, 0) + 1
        self._segment[rj.job.job_id] = epoch
        rj.epoch = epoch
        rj.expected_finish = t + downtime + rj.remaining_work_s / g
        rec = self.metrics.records[rj.job.job_id]
        rec.goodput = g
        rec.reconfig_downtime_s += downtime
        self._queue.push(
            JobFinish(time=rj.expected_finish, job_id=rj.job.job_id, epoch=epoch)
        )

    def _repair_or_ladder(self, rj: RunningJob, t: float) -> None:
        """Fault response for a running job whose circuits hit a dead
        switch/transceiver — the switch/link entry point of the recovery
        ladder (rung order and gating flags in the module docstring):

        1. repair in place (``circuit_repair``);
        2. partial-migrate the dead lines (``partial_migration``);
        3. evict and fall through to migrate -> shrink -> requeue.

        A repair whose repatch transaction aborts demotes to rung 2 just
        like an irreparable fault set (its circuits rolled back to the
        pre-repair state, which still avoids the dead hardware for every
        surviving rail — the job simply keeps paying its degradation)."""
        rec = self.metrics.records[rj.job.job_id]
        if self.circuit_repair:
            res = synthesize_degraded(
                self.cfg, rj.jmap.mapping, rj.alloc,
                frozenset(self.failed_switches),
                frozenset(self.failed_links),
            )
            if res is not None:
                new_target, factor = res
                if self.validate_circuits:
                    _check_port_discipline(self.cfg, new_target)
                trc = self.tracer
                if trc.enabled:
                    with trc.span(
                        "fault.repair", cat="fault",
                        job=rj.job.job_id, factor=factor,
                    ) as sp:
                        downtime = self._repatch(rj, new_target)
                        sp.set(
                            downtime_s=downtime, aborted=downtime is None
                        )
                else:
                    downtime = self._repatch(rj, new_target)
                if downtime is not None:
                    self._retime(rj, t, downtime, factor)
                    self.metrics.repairs += 1
                    rec.repairs += 1
                    return
        if self.partial_migration and self._partial_migrate(rj, t):
            return
        self.metrics.repair_fallbacks += 1
        remaining = self._evict(rj, t, lossy=True)
        self._recover_ladder(rj.job, remaining, t)

    def _partial_migrate(self, rj: RunningJob, t: float) -> bool:
        """Partial-migration rung: move only the allocation rows/columns
        whose rails are irreparably dead, keeping every surviving line —
        and the circuits already programmed on it — pinned in place.

        Replacement lines come from ``placement.partial_refit`` (a
        minimal sub-allocation diff against the occupancy index), and the
        circuit swap is one repatch (transactional under ``ocs_txn``), so
        mirror strokes are paid only on switches whose membership
        actually changed; ``bench_chaos`` records the stroke comparison
        against a full migrate.  The move is checkpoint-lossy exactly
        like a failure-driven eviction.  Returns False — scheduler state
        untouched — when no line is irreparable for this job, no
        replacement lines exist, the degraded re-synthesis cannot cover
        the new rectangle, or the repatch transaction aborts."""
        bad_rows, bad_cols = irreparable_lines(
            self.cfg, rj.jmap.mapping, rj.alloc,
            frozenset(self.failed_switches),
            frozenset(self.failed_links),
        )
        if not bad_rows and not bad_cols:
            return False
        new_alloc = partial_refit(
            self.n, self._occ, rj.alloc, bad_rows, bad_cols
        )
        if new_alloc is None:
            return False
        target = self._circuit_cache.target_for(rj.jmap.mapping, new_alloc)
        factor = 1.0
        if faults_hit_target(target, self.failed_switches, self.failed_links):
            res = synthesize_degraded(
                self.cfg, rj.jmap.mapping, new_alloc,
                frozenset(self.failed_switches),
                frozenset(self.failed_links),
            )
            if res is None:
                return False
            target, factor = res
        if self.validate_circuits:
            _check_port_discipline(self.cfg, target)
        # checkpoint loss model, same as a lossy eviction — computed up
        # front, but metrics mutate only after the repatch commits
        elapsed = max(0.0, t - rj.resumed_t)
        executed = min(rj.remaining_work_s, elapsed * rj.goodput)
        kept = executed
        interval = self.checkpoint_interval_s
        if interval is not None and interval > 0:
            kept = min(
                executed, math.floor(elapsed / interval) * interval * rj.goodput
            )
        trc = self.tracer
        if trc.enabled:
            with trc.span(
                "fault.partial_migrate", cat="fault",
                job=rj.job.job_id, factor=factor,
                moved_rows=len(bad_rows), moved_cols=len(bad_cols),
            ) as sp:
                downtime = self._repatch(rj, target)
                sp.set(downtime_s=downtime, aborted=downtime is None)
        else:
            downtime = self._repatch(rj, target)
        if downtime is None:
            return False             # txn aborted: fall to the next rung
        lost = executed - kept
        if lost > 0:
            self.metrics.lost_work_s += lost
            self.metrics.records[rj.job.job_id].lost_work_s += lost
        old_alloc = rj.alloc
        self._occ.release(old_alloc.rows, old_alloc.cols)
        self._occ.occupy(new_alloc.rows, new_alloc.cols)
        # footprint size is unchanged, so the occupied counter stands
        self._close_segment(rj, kept)
        rj.remaining_work_s -= kept
        rj.alloc = new_alloc
        g = rj.base_goodput * factor
        rj.goodput = g
        rj.degradation = factor
        rj.resumed_t = t + downtime
        epoch = self._segment.get(rj.job.job_id, 0) + 1
        self._segment[rj.job.job_id] = epoch
        rj.epoch = epoch
        rj.expected_finish = t + downtime + rj.remaining_work_s / g
        rec = self.metrics.records[rj.job.job_id]
        rec.goodput = g
        rec.reconfig_downtime_s += downtime
        rec.partial_migrations += 1
        self.metrics.partial_migrations += 1
        self._queue.push(
            JobFinish(time=rj.expected_finish, job_id=rj.job.job_id, epoch=epoch)
        )
        return True

    def _heal_running(self, t: float) -> None:
        """After a switch/link restore, re-synthesize every degraded job
        over the (smaller) surviving fault set: healed rails are
        reprogrammed and goodput steps back toward fault-free."""
        if not self.circuit_repair:
            return
        for jid in sorted(self.running):
            rj = self.running[jid]
            if rj.degradation >= 1.0:
                continue
            res = synthesize_degraded(
                self.cfg, rj.jmap.mapping, rj.alloc,
                frozenset(self.failed_switches),
                frozenset(self.failed_links),
            )
            if res is None:
                continue
            new_target, factor = res
            if new_target == rj.circuits and factor == rj.degradation:
                continue
            trc = self.tracer
            if trc.enabled:
                with trc.span(
                    "fault.restore", cat="fault", job=jid, factor=factor
                ) as sp:
                    downtime = self._repatch(rj, new_target)
                    sp.set(downtime_s=downtime, aborted=downtime is None)
            else:
                downtime = self._repatch(rj, new_target)
            if downtime is None:
                # heal transaction aborted: the job keeps running on its
                # (valid) degraded circuits; a later restore retries
                continue
            self._retime(rj, t, downtime, factor)
            self.metrics.repairs += 1
            self.metrics.records[jid].repairs += 1

    def _handle_switch_fail(self, ev: SwitchFail) -> None:
        key = ev.switch
        if key in self.failed_switches:
            return
        self.failed_switches.add(key)
        self.metrics.switch_faults += 1
        self._down_since.setdefault(("switch", key), ev.time)
        if self._flaps is not None:
            self._flaps.record_fail(("switch", key))
        # placement outcomes now depend on the fault set, so backlogged
        # jobs must be re-scanned even though the free set is unchanged
        self._occ.touch()
        # orphan circuits on the dead switch are gone with it (no strokes)
        orph = self._orphans.pop(key, None)
        if orph:
            cur = self.circuits.get(key, frozenset()) - frozenset(orph)
            if cur:
                self.circuits[key] = cur
            elif self.circuits.pop(key, None) is not None:
                self._line_sub(key)
        victims = sorted(
            (rj for rj in self.running.values() if key in rj.circuits),
            key=lambda rj: rj.job.job_id,
        )
        for rj in victims:
            self._repair_or_ladder(rj, ev.time)
        if self.services:
            self._serving_circuit_fault(ev.time, key, None)

    def _handle_link_fail(self, ev: LinkFail) -> None:
        link = ev.link
        if link in self.failed_links:
            return
        self.failed_links.add(link)
        self.metrics.link_faults += 1
        self._down_since.setdefault(("link", link), ev.time)
        if self._flaps is not None:
            self._flaps.record_fail(("link", link))
        self._occ.touch()
        victims = sorted(
            (
                rj for rj in self.running.values()
                if link_hits_circuits(link, rj.circuits)
            ),
            key=lambda rj: rj.job.job_id,
        )
        for rj in victims:
            self._repair_or_ladder(rj, ev.time)
        if self.services:
            self._serving_circuit_fault(ev.time, None, link)

    def _record_restore(self, entity: object, t: float) -> None:
        since = self._down_since.pop(entity, None)
        if since is not None:
            self.metrics.mttr_total_s += t - since
            self.metrics.mttr_count += 1

    def _restore_switch(self, key: SwitchKey, t: float) -> None:
        self.failed_switches.discard(key)
        self._record_restore(("switch", key), t)
        self._occ.touch()
        self._heal_running(t)
        if self.services:
            self._heal_replicas(t)
        self._drain_backlog(t)

    def _restore_link(self, link: LinkId, t: float) -> None:
        self.failed_links.discard(link)
        self._record_restore(("link", link), t)
        self._occ.touch()
        self._heal_running(t)
        if self.services:
            self._heal_replicas(t)
        self._drain_backlog(t)

    def _restore_node(self, node: Coord, t: float) -> None:
        self.faults.discard(node)
        self._occ.recover(node)
        self._occ_dirty = True                 # healthy count changed
        self._record_restore(("node", node), t)
        self._drain_backlog(t)
        self._maybe_expand(t)

    def _handle_node_recover(self, ev: NodeRecover) -> None:
        if ev.node in self.faults and self._flaps is not None:
            q = self._flaps.quarantine_s(("node", ev.node))
            if q is not None:
                # flapping node: hold it out of service for the burn-in
                self.metrics.quarantines += 1
                self._queue.push(
                    QuarantineRelease(
                        time=ev.time + q, kind="node", node=ev.node
                    )
                )
                return
        self._restore_node(ev.node, ev.time)

    def _handle_switch_recover(self, ev: SwitchRecover) -> None:
        if ev.switch not in self.failed_switches:
            return
        if self._flaps is not None:
            q = self._flaps.quarantine_s(("switch", ev.switch))
            if q is not None:
                self.metrics.quarantines += 1
                self._queue.push(
                    QuarantineRelease(
                        time=ev.time + q, kind="switch", switch=ev.switch
                    )
                )
                return
        self._restore_switch(ev.switch, ev.time)

    def _handle_link_recover(self, ev: LinkRecover) -> None:
        if ev.link not in self.failed_links:
            return
        if self._flaps is not None:
            q = self._flaps.quarantine_s(("link", ev.link))
            if q is not None:
                # flapping transceiver: burn it in before reprogramming
                # circuits over it (same policy as nodes and switches)
                self.metrics.quarantines += 1
                self._queue.push(
                    QuarantineRelease(
                        time=ev.time + q, kind="link", link=ev.link
                    )
                )
                return
        self._restore_link(ev.link, ev.time)

    def _handle_quarantine_release(self, ev: QuarantineRelease) -> None:
        """A completed burn-in: the flap record resets and the entity
        rejoins service through the normal restore path."""
        if ev.kind == "node" and ev.node is not None:
            if self._flaps is not None:
                self._flaps.release(("node", ev.node))
            if ev.node in self.faults:
                self._restore_node(ev.node, ev.time)
        elif ev.kind == "switch" and ev.switch is not None:
            if self._flaps is not None:
                self._flaps.release(("switch", ev.switch))
            if ev.switch in self.failed_switches:
                self._restore_switch(ev.switch, ev.time)
        elif ev.kind == "link" and ev.link is not None:
            if self._flaps is not None:
                self._flaps.release(("link", ev.link))
            if ev.link in self.failed_links:
                self._restore_link(ev.link, ev.time)

    # -- serving (MLaaS digital twin) -----------------------------

    def _handle_rate_update(self, ev: RateUpdate) -> None:
        st = self.services.get(ev.service_id)
        if st is None:
            return
        st.advance_to(ev.time)
        st.rate_rps = ev.rate_rps
        if self.serving is None or not self.serving.autoscale:
            return
        want = desired_replicas(
            st.spec, ev.rate_rps, st.healthy_replica_rate(),
            self.serving.target_utilization,
        )
        cur = len(st.replicas)
        trc = self.tracer
        if trc.enabled:
            trc.instant(
                "serving.autoscale", cat="serving",
                service=ev.service_id, rate_rps=ev.rate_rps,
                replicas=cur, desired=want,
            )
        if want > cur:
            st.down_ticks = 0
            self._queue.push(ReplicaScale(
                time=ev.time, service_id=ev.service_id, target_replicas=want,
            ))
        elif want < cur:
            # hysteresis: shrink only after scale_down_ticks consecutive
            # low samples, so a single quiet bin can't thrash the OCS
            st.down_ticks += 1
            if st.down_ticks >= self.serving.scale_down_ticks:
                st.down_ticks = 0
                self._queue.push(ReplicaScale(
                    time=ev.time, service_id=ev.service_id,
                    target_replicas=want,
                ))
        else:
            st.down_ticks = 0

    def _handle_replica_scale(self, ev: ReplicaScale) -> None:
        st = self.services.get(ev.service_id)
        if st is None:
            return
        st.advance_to(ev.time)
        target = max(
            st.spec.min_replicas, min(st.spec.max_replicas, ev.target_replicas)
        )
        self.metrics.replica_scale_events += 1
        freed = False
        while len(st.replicas) > target:
            self._remove_replica(st)
            st.scale_downs += 1
            self.metrics.serving_scale_downs += 1
            freed = True
        while len(st.replicas) < target:
            if self._place_replica(st, ev.time):
                st.scale_ups += 1
                self.metrics.serving_scale_ups += 1
            elif (
                self.serving is not None and self.serving.preempt_training
                and self._preempt_for_replica(st, ev.time)
            ):
                st.scale_ups += 1
                self.metrics.serving_scale_ups += 1
            else:
                st.scale_failures += 1
                self.metrics.serving_scale_failures += 1
                break
        st.mark_replicas(ev.time)
        if freed:
            self._drain_backlog(ev.time)

    def _place_replica(self, st: ServiceState, t: float) -> bool:
        jmap = self._solve_mapping(self._service_pseudo[st.spec.service_id])
        trc = self.tracer
        if not trc.enabled:
            return self._do_place_replica(st, jmap)
        with trc.span(
            "serving.place", cat="serving",
            service=st.spec.service_id,
            rows_req=jmap.rows_req, cols_req=jmap.cols_req,
        ) as sp:
            ok = self._do_place_replica(st, jmap)
            sp.set(placed=ok)
            return ok

    def _do_place_replica(self, st: ServiceState, jmap: JobMapping) -> bool:
        """Replica placement through the normal machinery: policy scan,
        circuit synthesis (degraded over live faults), checked install.
        Skips the headroom gate — the reserve exists *for* serving."""
        self.metrics.placement_attempts += 1
        if jmap.nodes > self.n * self.n:
            return False
        if not self._occ.can_fit(jmap.rows_req, jmap.cols_req):
            return False
        self.metrics.placement_scans += 1
        alloc = self._scan_policy(self._occ, jmap)
        if alloc is None:
            return False
        target = self._circuit_cache.target_for(jmap.mapping, alloc)
        factor = 1.0
        if self.circuit_repair and (self.failed_switches or self.failed_links):
            if faults_hit_target(
                target, self.failed_switches, self.failed_links
            ):
                res = synthesize_degraded(
                    self.cfg, jmap.mapping, alloc,
                    frozenset(self.failed_switches),
                    frozenset(self.failed_links),
                )
                if res is None:
                    return False
                target, factor = res
        inst = self._install_checked(target)
        if inst is None:
            return False
        self._occ.occupy(alloc.rows, alloc.cols)
        self._occupied_count += alloc.size
        self._occ_dirty = True
        st.replicas.append(Replica(alloc=alloc, circuits=target, factor=factor))
        return True

    def _remove_replica(self, st: ServiceState) -> None:
        rep = st.replicas.pop()
        self._uninstall(rep.circuits)
        self._occ.release(rep.alloc.rows, rep.alloc.cols)
        self._occupied_count -= rep.alloc.size
        self._occ_dirty = True

    def _evict_replica(self, st: ServiceState, idx: int) -> None:
        rep = st.replicas.pop(idx)
        self._uninstall(rep.circuits)
        self._occ.release(rep.alloc.rows, rep.alloc.cols)
        self._occupied_count -= rep.alloc.size
        self._occ_dirty = True

    def _preempt_for_replica(self, st: ServiceState, t: float) -> bool:
        """Serving preemption priority: evict the cheapest strictly-lower
        -tier training victims, then place the replica in the hole.  No
        placed assertion — a transactional install can still abort."""
        pseudo = self._service_pseudo[st.spec.service_id]
        jmap = self._solve_mapping(pseudo)
        victims = self.select_victims(pseudo, t, jmap=jmap)
        if victims is None:
            return False
        for rj in victims:
            remaining = self._evict(rj, t)
            rec = self.metrics.records[rj.job.job_id]
            rec.preemptions += 1
            self.metrics.preemptions += 1
            self.metrics.serving_preemptions += 1
            st.preemptions += 1
            self.backlog.push_front(
                dataclasses.replace(rj.job, service_s=remaining)
            )
            self._backlog_seen.pop(rj.job.job_id, None)
        placed = self._place_replica(st, t)
        self._drain_backlog(t)
        return placed

    def _serving_circuit_fault(
        self, t: float, key: Optional[SwitchKey], link: Optional[LinkId]
    ) -> None:
        """Switch/link fault entry for replicas: each hit replica walks
        the same repair -> migrate -> evict ladder as a training job."""
        for sid in sorted(self.services):
            st = self.services[sid]
            hit = [
                i for i, rep in enumerate(st.replicas)
                if (key is not None and key in rep.circuits)
                or (link is not None and link_hits_circuits(link, rep.circuits))
            ]
            if not hit:
                continue
            st.advance_to(t)
            for i in reversed(hit):
                self._repair_or_evict_replica(st, i, t)
            st.mark_replicas(t)

    def _repair_or_evict_replica(self, st: ServiceState, idx: int, t: float) -> None:
        rep = st.replicas[idx]
        jmap = self._solve_mapping(self._service_pseudo[st.spec.service_id])
        if self.circuit_repair:
            res = synthesize_degraded(
                self.cfg, jmap.mapping, rep.alloc,
                frozenset(self.failed_switches),
                frozenset(self.failed_links),
            )
            if res is not None:
                new_target, factor = res
                if self.validate_circuits:
                    _check_port_discipline(self.cfg, new_target)
                downtime = self._repatch(rep, new_target)
                if downtime is not None:
                    # rung 1: repaired in place; the surviving-rail factor
                    # scales the ServiceModel's inter-node bandwidth term
                    rep.factor = factor
                    st.repairs += 1
                    self.metrics.serving_repairs += 1
                    return
        # irreparable (or txn aborted): evict and try an immediate re-place
        self._evict_replica(st, idx)
        if self._place_replica(st, t):
            st.migrations += 1
            self.metrics.serving_migrations += 1
        else:
            st.fault_evictions += 1
            self.metrics.serving_fault_evictions += 1

    def _serving_node_fault(self, ev: NodeFail) -> None:
        for sid in sorted(self.services):
            st = self.services[sid]
            for i, rep in enumerate(st.replicas):
                if ev.node[0] in rep.alloc.rows and ev.node[1] in rep.alloc.cols:
                    st.advance_to(ev.time)
                    self._evict_replica(st, i)
                    if self._place_replica(st, ev.time):
                        st.migrations += 1
                        self.metrics.serving_migrations += 1
                    else:
                        st.fault_evictions += 1
                        self.metrics.serving_fault_evictions += 1
                    st.mark_replicas(ev.time)
                    break

    def _heal_replicas(self, t: float) -> None:
        """After a restore, re-synthesize degraded replicas over the
        smaller fault set (the serving analog of ``_heal_running``)."""
        if not self.circuit_repair:
            return
        for sid in sorted(self.services):
            st = self.services[sid]
            touched = False
            for rep in st.replicas:
                if rep.factor >= 1.0:
                    continue
                jmap = self._solve_mapping(
                    self._service_pseudo[st.spec.service_id]
                )
                res = synthesize_degraded(
                    self.cfg, jmap.mapping, rep.alloc,
                    frozenset(self.failed_switches),
                    frozenset(self.failed_links),
                )
                if res is None:
                    continue
                new_target, factor = res
                if new_target == rep.circuits and factor == rep.factor:
                    continue
                if not touched:
                    st.advance_to(t)
                    touched = True
                downtime = self._repatch(rep, new_target)
                if downtime is None:
                    continue
                rep.factor = factor
                st.repairs += 1
                self.metrics.serving_repairs += 1

    def serving_summary(
        self, until: Optional[float] = None
    ) -> Dict[str, object]:
        """Per-service + aggregate serving figures (``until`` closes the
        open accounting interval first, like ``run(until=...)`` callers
        expect)."""
        per: Dict[str, object] = {}
        total_req = 0.0
        total_att = 0.0
        total_wait = 0.0
        total_p99 = 0.0
        total_stable = 0.0
        for sid in sorted(self.services):
            st = self.services[sid]
            if until is not None:
                st.advance_to(until)
            per[str(sid)] = st.summary()
            total_req += st.requests
            total_att += st.attained
            total_wait += st.wait_request_s
            total_p99 += st.p99_s_weighted
            total_stable += st.stable_s
        out: Dict[str, object] = {
            "services": per,
            "slo_attainment": round(
                total_att / total_req, 4
            ) if total_req > 0 else 1.0,
            "mean_queue_wait_s": round(
                total_wait / total_req, 4
            ) if total_req > 0 else 0.0,
            "p99_queue_delay_s": round(
                total_p99 / total_stable, 4
            ) if total_stable > 0 else 0.0,
            "requests": round(total_req, 3),
        }
        out.update(self.metrics.serving_summary())
        return out

    # -- event loop ---------------------------------------------------------

    def _dispatch(self, ev: Event) -> None:
        if isinstance(ev, JobSubmit):
            job = ev.job
            self.metrics.records.setdefault(
                job.job_id, JobRecord(job=job, submit_t=ev.time)
            )
            self._orig_spec.setdefault(job.job_id, job)
            if not self._try_place(job, ev.time):
                if self.preemption and self._try_preempt(job, ev.time):
                    return
                self.backlog.push(job)
                self._backlog_seen[job.job_id] = self._occ.version
        elif isinstance(ev, JobFinish):
            rj = self.running.get(ev.job_id)
            if rj is None or ev.epoch != rj.epoch:
                return  # stale finish from a superseded run segment
            rec = self.metrics.records[ev.job_id]
            self._close_segment(rj, rj.remaining_work_s)
            self._uninstall(rj.circuits)
            self._occ.release(rj.alloc.rows, rj.alloc.cols)
            self._occupied_count -= rj.alloc.size
            self._occ_dirty = True
            del self.running[ev.job_id]
            rec.finish_t = ev.time
            self._drain_backlog(ev.time)
            self._maybe_expand(ev.time)
        elif isinstance(ev, NodeFail):
            self._handle_node_fail(ev)
        elif isinstance(ev, NodeRecover):
            self._handle_node_recover(ev)
        elif isinstance(ev, SwitchFail):
            self._handle_switch_fail(ev)
        elif isinstance(ev, SwitchRecover):
            self._handle_switch_recover(ev)
        elif isinstance(ev, LinkFail):
            self._handle_link_fail(ev)
        elif isinstance(ev, LinkRecover):
            self._handle_link_recover(ev)
        elif isinstance(ev, QuarantineRelease):
            self._handle_quarantine_release(ev)
        elif isinstance(ev, RateUpdate):
            self._handle_rate_update(ev)
        elif isinstance(ev, ReplicaScale):
            self._handle_replica_scale(ev)
        else:  # pragma: no cover
            raise TypeError(f"unknown event {ev!r}")

    def enqueue(self, events: Iterable[Event]) -> None:
        """Stream events into the queue without running the loop (lets a
        benchmark separate trace generation from event-loop timing while
        still never materializing the trace as a list)."""
        for ev in events:
            self._queue.push(ev)

    def run(
        self, events: Iterable[Event] = (), until: Optional[float] = None
    ) -> TimelineMetrics:
        """Process events in time order; ``until`` stops the loop once the
        next event lies beyond it (pending events stay queued, so ``run``
        can be called again to continue)."""
        self.enqueue(events)
        self._sync_occupancy()
        while self._queue:
            next_t = self._queue.peek_time()
            if until is not None and next_t is not None and next_t > until:
                break
            ev = self._queue.pop()
            assert ev is not None
            self.metrics.advance(ev.time)
            trc = self.tracer
            if trc.enabled:
                with trc.span(
                    "event." + type(ev).__name__,
                    cat="scheduler",
                    **_event_trace_args(ev),
                ):
                    self._dispatch(ev)
            else:
                self._dispatch(ev)
            self._sync_occupancy()
            self.metrics.events_processed += 1
        if until is not None:
            # charge the tail window [last event, until] to the node-second
            # integrals — stopping at the horizon used to silently drop it
            # from util_node_seconds / healthy_node_seconds
            next_t = self._queue.peek_time()
            self.metrics.advance(until if next_t is None else min(until, next_t))
        self._sync_cache_stats()
        return self.metrics

    # -- rendering ----------------------------------------------------------

    def render(self) -> str:
        """ASCII grid: '.' free, 'X' fault, job ids mod 10 for occupancy."""
        grid = [["." for _ in range(self.n)] for _ in range(self.n)]
        for (r, c) in self.faults:
            grid[r][c] = "X"
        for rj in self.running.values():
            ch = str(rj.job.job_id % 10)
            for r in rj.alloc.rows:
                for c in rj.alloc.cols:
                    grid[r][c] = ch
        return "\n".join(" ".join(row) for row in grid)
