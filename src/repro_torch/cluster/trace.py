"""Trace generation for the MLaaS scheduler (paper §6.6 Figure 20).

The port's own copy of ``repro/cluster/trace.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

``poisson_trace`` draws job arrivals from a Poisson process over a mix
of registry architectures (each with its default parallelism plan);
``failure_trace`` injects node-fail / node-recover pairs with
exponential inter-arrival and repair times; ``fig20_trace`` is the
paper-style fixed scenario: several heterogeneous jobs arriving
back-to-back onto a faulted grid.

All randomness flows through one ``random.Random(seed)`` so a trace is a
pure function of its arguments (the scheduler itself is deterministic).
The ``iter_*`` variants are lazy generators producing the identical
event sequence — the scheduler consumes any iterable, so benchmarks can
stream a day-long trace straight into the event queue without ever
materializing the intermediate list.
"""

from __future__ import annotations

import bisect
import csv
import dataclasses
import heapq
import json
import math
import random
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from ..core.mapping import ParallelismPlan
from .events import (
    Event,
    JobSubmit,
    LinkFail,
    LinkRecover,
    NodeFail,
    NodeRecover,
    SwitchFail,
    SwitchRecover,
)
from .faults import FaultDomain
from .jobs import JobSpec, default_plan, make_job

DEFAULT_MIX: Tuple[str, ...] = (
    "qwen3-8b",
    "paper-llama3-moe",
    "whisper-large-v3",
    "llama3.2-3b",
    "gemma3-4b",
)


def iter_poisson_trace(
    *,
    seed: int = 0,
    duration_s: float = 4 * 3600.0,
    arrival_rate_per_h: float = 6.0,
    archs: Sequence[str] = DEFAULT_MIX,
    mean_service_s: float = 3600.0,
    start_id: int = 0,
    tier_weights: Optional[Sequence[float]] = None,
) -> Iterator[JobSubmit]:
    """Poisson job arrivals with exponential service demands (lazy).

    ``tier_weights`` optionally assigns each job an SLO tier drawn with
    the given (unnormalized) weights — index i is tier i, higher tiers
    are more important.  The draw costs one extra ``rng.random()`` per
    job, so the default (``None``) produces the byte-identical event
    sequence the un-tiered generator always produced.
    """
    rng = random.Random(seed)
    t = 0.0
    jid = start_id
    cum: Optional[List[float]] = None
    if tier_weights is not None:
        total = float(sum(tier_weights))
        acc = 0.0
        cum = []
        for w in tier_weights:
            acc += w / total
            cum.append(acc)
    while True:
        t += rng.expovariate(arrival_rate_per_h / 3600.0)
        if t >= duration_s:
            break
        arch = rng.choice(list(archs))
        service = max(60.0, rng.expovariate(1.0 / mean_service_s))
        tier = 0
        if cum is not None:
            u = rng.random()
            # fall back to the last tier when float accumulation leaves
            # cum[-1] a few ulps below 1.0 and u lands above it
            tier = next(
                (i for i, c in enumerate(cum) if u <= c), len(cum) - 1
            )
        yield JobSubmit(
            time=t, job=make_job(jid, arch, service_s=service, tier=tier)
        )
        jid += 1


def poisson_trace(**kwargs) -> List[JobSubmit]:
    """Materialized ``iter_poisson_trace`` (same arguments and events)."""
    return list(iter_poisson_trace(**kwargs))


def iter_failure_trace(
    *,
    n: int,
    seed: int = 0,
    duration_s: float = 4 * 3600.0,
    mtbf_node_s: float = 1e7,
    mttr_s: float = 1800.0,
    emit_horizon_recoveries: bool = False,
) -> Iterator[Event]:
    """Node failures over an n x n grid (lazy): cluster-level failure
    rate is n^2 / mtbf_node_s; each failure schedules its recovery after
    an exponential repair time.

    The up-node set is maintained incrementally (sorted node-id list +
    repair-time heap) instead of rebuilding an O(n^2) candidate list per
    failure event, which dominated trace generation at 128x128 (16K
    coords).  The rng draw order and the row-major candidate indexing
    match :func:`_iter_failure_trace_ref` exactly, so the event sequence
    is identical (asserted in the reference's ``tests/test_policy.py``).

    ``emit_horizon_recoveries`` also yields ``NodeRecover`` events whose
    repair lands past ``duration_s``: the seed behavior dropped them, so
    a node failing near the horizon stays down forever in any run
    extended past the trace window.  Off by default — the default event
    sequence (and every seeded fingerprint built on it) is unchanged; the
    rng draw order is identical in both modes.
    """
    rng = random.Random(seed ^ 0x5DEECE66D)
    t = 0.0
    rate = n * n / mtbf_node_s
    up: List[int] = list(range(n * n))        # node ids r*n + c, sorted
    repairs: List[Tuple[float, int]] = []     # (repair time, node id) heap
    while True:
        t += rng.expovariate(rate)
        if t >= duration_s:
            break
        # nodes whose repair has completed by now are eligible again
        # (strictly-later repairs stay down, matching the reference's
        # ``rt > t`` filter)
        while repairs and repairs[0][0] <= t:
            _, nid = heapq.heappop(repairs)
            bisect.insort(up, nid)
        if not up:
            continue
        nid = up.pop(rng.randrange(len(up)))
        node = (nid // n, nid % n)
        yield NodeFail(time=t, node=node)
        repair = t + max(60.0, rng.expovariate(1.0 / mttr_s))
        heapq.heappush(repairs, (repair, nid))
        if repair < duration_s or emit_horizon_recoveries:
            yield NodeRecover(time=repair, node=node)


def _iter_failure_trace_ref(
    *,
    n: int,
    seed: int = 0,
    duration_s: float = 4 * 3600.0,
    mtbf_node_s: float = 1e7,
    mttr_s: float = 1800.0,
    emit_horizon_recoveries: bool = False,
) -> Iterator[Event]:
    """Seed implementation of :func:`iter_failure_trace` rebuilding the
    candidate list per event — kept as the equivalence-test oracle."""
    rng = random.Random(seed ^ 0x5DEECE66D)
    t = 0.0
    rate = n * n / mtbf_node_s
    down: Dict[Tuple[int, int], float] = {}   # node -> repair time
    while True:
        t += rng.expovariate(rate)
        if t >= duration_s:
            break
        # nodes whose repair has completed by now are eligible again
        down = {nd: rt for nd, rt in down.items() if rt > t}
        candidates = [
            (r, c) for r in range(n) for c in range(n) if (r, c) not in down
        ]
        if not candidates:
            continue
        node = candidates[rng.randrange(len(candidates))]
        yield NodeFail(time=t, node=node)
        repair = t + max(60.0, rng.expovariate(1.0 / mttr_s))
        down[node] = repair
        if repair < duration_s or emit_horizon_recoveries:
            yield NodeRecover(time=repair, node=node)


def failure_trace(**kwargs) -> List[Event]:
    """Materialized ``iter_failure_trace`` (same arguments and events)."""
    return list(iter_failure_trace(**kwargs))


def iter_fault_domain_trace(
    *,
    n: int,
    rails: int = 16,
    seed: int = 0,
    duration_s: float = 4 * 3600.0,
    mtbf_node_s: float = 1e7,
    mttr_node_s: float = 1800.0,
    mtbf_switch_s: float = 0.0,
    mttr_switch_s: float = 3600.0,
    mtbf_link_s: float = 0.0,
    mttr_link_s: float = 900.0,
    mtbf_row_power_s: float = 0.0,
    mttr_row_power_s: float = 7200.0,
    row_group_rows: int = 4,
    emit_horizon_recoveries: bool = True,
) -> Iterator[Event]:
    """Correlated fault-domain failures over an n x n grid with ``rails``
    rails per physical dimension (lazy; see ``faults.FaultDomain``).

    Four competing exponential processes, each an MTBF per *entity* (a
    zero MTBF disables the domain):

    * **node** — n^2 entities, one ``NodeFail``/``NodeRecover`` pair;
    * **switch** — ``2 * n * rails`` OCS units keyed ``(dim, group,
      rail)``, one ``SwitchFail``/``SwitchRecover`` pair;
    * **link** — ``2 * n^2 * rails`` transceivers, one
      ``LinkFail``/``LinkRecover`` pair;
    * **row_power** — ``ceil(n / row_group_rows)`` rack feeds; a failure
      emits a simultaneous ``NodeFail`` for every up node in its row
      block and one shared recovery instant for exactly those nodes
      (individually-failed nodes keep their own repair schedule).

    Failed entities leave their domain's candidate set until repaired,
    so the generator never double-fails a down entity.  All randomness
    flows through one ``random.Random(seed)``: the event sequence is a
    pure function of the arguments (replay-determinism is one of the
    ``bench_chaos`` invariants).  Unlike the node-only generator,
    horizon-crossing recoveries are emitted by default — correlated
    scenarios are usually run past the injection window to watch the
    cluster heal.
    """
    domains = [
        FaultDomain("node", n * n, mtbf_node_s, mttr_node_s),
        FaultDomain("switch", 2 * n * rails, mtbf_switch_s, mttr_switch_s),
        FaultDomain("link", 2 * n * n * rails, mtbf_link_s, mttr_link_s),
        FaultDomain(
            "row_power",
            -(-n // row_group_rows),
            mtbf_row_power_s,
            mttr_row_power_s,
        ),
    ]
    total_rate = sum(d.rate for d in domains)
    if total_rate <= 0:
        return
    rng = random.Random(seed ^ 0x5DEECE66D)
    # sorted up-entity id lists per domain (row_power groups double as ids)
    up: Dict[str, List[int]] = {
        "node": list(range(n * n)),
        "switch": list(range(2 * n * rails)),
        "link": list(range(2 * n * n * rails)),
        "row_power": list(range(-(-n // row_group_rows))),
    }
    # repair heap: (time, seq, kind, entity id, downed-node ids for groups)
    repairs: List[Tuple[float, int, str, int, Tuple[int, ...]]] = []
    seq = 0

    def node_coord(nid: int) -> Tuple[int, int]:
        return (nid // n, nid % n)

    def switch_key(sid: int) -> Tuple[str, int, int]:
        dim_i, rest = divmod(sid, n * rails)
        group, rail = divmod(rest, rails)
        return ("X" if dim_i == 0 else "Y", group, rail)

    def link_id(lid: int) -> Tuple[Tuple[int, int], str, int]:
        rest, rail = divmod(lid, rails)
        nid, dim_i = divmod(rest, 2)
        return (node_coord(nid), "X" if dim_i == 0 else "Y", rail)

    t = 0.0
    while True:
        t += rng.expovariate(total_rate)
        if t >= duration_s:
            break
        while repairs and repairs[0][0] <= t:
            rt, _, kind, eid, downed = heapq.heappop(repairs)
            bisect.insort(up[kind], eid)
            if kind == "row_power":
                for nid in downed:
                    bisect.insort(up["node"], nid)
        u = rng.random() * total_rate
        acc = 0.0
        dom = domains[-1]
        for d in domains:
            acc += d.rate
            if u < acc:
                dom = d
                break
        cand = up[dom.kind]
        if not cand:
            continue
        eid = cand.pop(rng.randrange(len(cand)))
        repair = t + max(60.0, rng.expovariate(1.0 / dom.mttr_s))
        emit_recover = repair < duration_s or emit_horizon_recoveries
        downed: Tuple[int, ...] = ()
        if dom.kind == "node":
            node = node_coord(eid)
            yield NodeFail(time=t, node=node)
            if emit_recover:
                yield NodeRecover(time=repair, node=node)
        elif dom.kind == "switch":
            key = switch_key(eid)
            yield SwitchFail(time=t, switch=key)
            if emit_recover:
                yield SwitchRecover(time=repair, switch=key)
        elif dom.kind == "link":
            node, dim, rail = link_id(eid)
            yield LinkFail(time=t, node=node, dim=dim, rail=rail)
            if emit_recover:
                yield LinkRecover(time=repair, node=node, dim=dim, rail=rail)
        else:  # row_power: down every currently-up node in the row block
            r_lo = eid * row_group_rows
            r_hi = min(n, r_lo + row_group_rows)
            hit = [
                nid for nid in up["node"]
                if r_lo <= nid // n < r_hi
            ]
            for nid in hit:
                up["node"].remove(nid)
                yield NodeFail(time=t, node=node_coord(nid))
            if emit_recover:
                for nid in hit:
                    yield NodeRecover(time=repair, node=node_coord(nid))
            downed = tuple(hit)
        heapq.heappush(repairs, (repair, seq, dom.kind, eid, downed))
        seq += 1


def fault_domain_trace(**kwargs) -> List[Event]:
    """Materialized ``iter_fault_domain_trace`` (same arguments/events)."""
    return list(iter_fault_domain_trace(**kwargs))


def fig20_trace(
    *,
    service_s: float = 7200.0,
    archs: Sequence[str] = DEFAULT_MIX,
    plans: Optional[Dict[str, ParallelismPlan]] = None,
    stagger_s: float = 60.0,
    start_id: int = 0,
) -> List[JobSubmit]:
    """Paper-style multi-job scenario: heterogeneous jobs submitted
    back-to-back (Figure 20's co-resident training jobs)."""
    plans = plans or {}
    events = []
    for i, arch in enumerate(archs):
        plan = plans.get(arch, default_plan(arch))
        events.append(
            JobSubmit(
                time=i * stagger_s,
                job=make_job(start_id + i, arch, plan=plan, service_s=service_s),
            )
        )
    return events


def replay_trace(events: Iterable[Event]) -> List[Event]:
    """Normalize an arbitrary event collection into time order (the
    scheduler's queue re-sorts anyway; this keeps traces inspectable)."""
    return sorted(events, key=lambda e: e.time)


# ---------------------------------------------------------------------------
# Trace-driven chaos replay (recorded / Weibull availability traces)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AvailabilityRecord:
    """One recorded down-up interval of one entity, as an availability
    log would store it (fleet telemetry rather than a stochastic model).

    ``kind`` is ``node`` / ``switch`` / ``link``; ``entity`` the matching
    identifier (a ``(r, c)`` coord, a ``(dim, group, rail)`` switch key,
    or a ``(node, dim, rail)`` link id).  ``up_t=None`` records an entity
    that never came back inside the log window."""

    kind: str
    entity: object
    down_t: float
    up_t: Optional[float] = None


_RECORD_KINDS = ("node", "switch", "link")


def validate_availability_records(
    records: Sequence[AvailabilityRecord],
) -> None:
    """Reject malformed availability logs: unknown kinds, inverted
    intervals, and overlapping intervals of the same entity (an entity
    cannot fail again before it was repaired).  Shared by the replayer
    and the file loader so recorded and ingested traces meet one bar."""
    by_entity: Dict[Tuple[str, object], List[AvailabilityRecord]] = {}
    for rec in records:
        if rec.kind not in _RECORD_KINDS:
            raise ValueError(
                f"unknown availability record kind {rec.kind!r} "
                f"(expected one of {_RECORD_KINDS})"
            )
        if rec.up_t is not None and rec.up_t < rec.down_t:
            raise ValueError(
                f"inverted availability interval for {rec.kind} "
                f"{rec.entity!r}: up at {rec.up_t} before down at "
                f"{rec.down_t}"
            )
        by_entity.setdefault((rec.kind, rec.entity), []).append(rec)
    # sorted so the first-reported error is independent of input order
    for (kind, ent), recs in sorted(
        by_entity.items(), key=lambda kv: (kv[0][0], repr(kv[0][1]))
    ):
        ordered = sorted(recs, key=lambda r: r.down_t)
        for a, b in zip(ordered, ordered[1:]):
            if a.up_t is None or b.down_t < a.up_t:
                raise ValueError(
                    f"overlapping availability intervals for {kind} {ent!r}: "
                    f"down at {b.down_t} before repair of the interval "
                    f"starting {a.down_t}"
                )


def replay_availability_trace(
    records: Sequence[AvailabilityRecord],
) -> List[Event]:
    """Deterministically expand recorded down-up intervals into the
    scheduler's fail/recover event stream (time-sorted, input order
    preserved among simultaneous events — replaying the same records
    always yields the identical list, which is what lets ``bench_chaos``
    assert byte-exact replay fidelity on recorded scenarios).

    Raises ``ValueError`` when two intervals of the same entity overlap
    (a log corruption the memoryless generators can never produce: an
    entity cannot fail again before it was repaired)."""
    validate_availability_records(records)
    events: List[Event] = []
    for rec in records:
        if rec.kind == "node":
            events.append(NodeFail(time=rec.down_t, node=rec.entity))
            if rec.up_t is not None:
                events.append(NodeRecover(time=rec.up_t, node=rec.entity))
        elif rec.kind == "switch":
            events.append(SwitchFail(time=rec.down_t, switch=rec.entity))
            if rec.up_t is not None:
                events.append(SwitchRecover(time=rec.up_t, switch=rec.entity))
        elif rec.kind == "link":
            node, dim, rail = rec.entity
            events.append(
                LinkFail(time=rec.down_t, node=node, dim=dim, rail=rail)
            )
            if rec.up_t is not None:
                events.append(
                    LinkRecover(time=rec.up_t, node=node, dim=dim, rail=rail)
                )
        else:
            raise ValueError(f"unknown availability record kind {rec.kind!r}")
    return replay_trace(events)


def dump_availability_records(
    records: Sequence[AvailabilityRecord], path
) -> None:
    """Write an availability log to ``path``: CSV for ``*.csv`` (header
    ``kind,entity,down_t,up_t``; the entity encoded as compact JSON, an
    empty ``up_t`` for never-repaired), JSON Lines otherwise.  Floats
    use their shortest round-trippable form, so dump → load → replay is
    byte-identical to replaying the in-memory records."""
    path = str(path)
    if path.endswith(".csv"):
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["kind", "entity", "down_t", "up_t"])
            for rec in records:
                writer.writerow([
                    rec.kind,
                    json.dumps(rec.entity, separators=(",", ":")),
                    repr(float(rec.down_t)),
                    "" if rec.up_t is None else repr(float(rec.up_t)),
                ])
    else:
        with open(path, "w") as f:
            for rec in records:
                f.write(json.dumps(
                    {
                        "kind": rec.kind,
                        "entity": rec.entity,
                        "down_t": rec.down_t,
                        "up_t": rec.up_t,
                    },
                    separators=(",", ":"),
                ))
                f.write("\n")


def _entity_from_json(obj):
    """JSON arrays back to the tuples the events/faults layers key on
    (``(r, c)`` coords, ``(dim, group, rail)`` switch keys, nested link
    ids)."""
    if isinstance(obj, list):
        return tuple(_entity_from_json(x) for x in obj)
    return obj


def load_availability_records(path) -> List[AvailabilityRecord]:
    """Read an availability log written by
    :func:`dump_availability_records` (or fleet telemetry exported in
    the same shape): CSV for ``*.csv``, JSON Lines otherwise.  Entities
    come back as tuples, the stream is validated with
    :func:`validate_availability_records`, and malformed rows raise
    ``ValueError`` naming the offending line."""
    path = str(path)
    records: List[AvailabilityRecord] = []
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            required = {"kind", "entity", "down_t", "up_t"}
            if reader.fieldnames is None or not required.issubset(
                reader.fieldnames
            ):
                raise ValueError(
                    f"{path}: expected CSV header kind,entity,down_t,up_t "
                    f"(got {reader.fieldnames})"
                )
            for lineno, row in enumerate(reader, start=2):
                try:
                    records.append(AvailabilityRecord(
                        kind=row["kind"],
                        entity=_entity_from_json(json.loads(row["entity"])),
                        down_t=float(row["down_t"]),
                        up_t=float(row["up_t"]) if row["up_t"] else None,
                    ))
                except (ValueError, TypeError, KeyError) as e:
                    raise ValueError(
                        f"{path}:{lineno}: malformed availability row: {e}"
                    ) from e
    else:
        with open(path) as f:
            for lineno, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    records.append(AvailabilityRecord(
                        kind=obj["kind"],
                        entity=_entity_from_json(obj["entity"]),
                        down_t=float(obj["down_t"]),
                        up_t=(
                            float(obj["up_t"])
                            if obj.get("up_t") is not None else None
                        ),
                    ))
                except (ValueError, TypeError, KeyError) as e:
                    raise ValueError(
                        f"{path}:{lineno}: malformed availability record: "
                        f"{e}"
                    ) from e
    validate_availability_records(records)
    return records


def generate_weibull_records(
    *,
    n: int,
    rails: int = 16,
    seed: int = 0,
    duration_s: float = 8 * 3600.0,
    mtbf_node_s: float = 0.0,
    mtbf_switch_s: float = 0.0,
    mtbf_link_s: float = 0.0,
    mttr_s: float = 1800.0,
    shape: float = 1.6,
    burst_mean: float = 2.0,
) -> List[AvailabilityRecord]:
    """Synthesize an availability log with non-Poisson statistics: burst
    arrivals with Weibull-shaped inter-burst gaps.

    ``shape > 1`` models aging hardware (increasing hazard — failures
    cluster later in the window), ``shape < 1`` infant mortality; the
    Weibull scale is chosen so the *mean* cluster-level inter-burst gap
    still equals ``mtbf / entities``, making rows comparable with the
    exponential scenarios at equal budgets.  Each burst downs a
    geometrically-sized batch (mean ``burst_mean``) of distinct up
    entities of one kind with a shared repair instant — the correlated
    batch-maintenance pattern that memoryless per-entity traces cannot
    express.  A zero MTBF disables that kind.  Pure function of its
    arguments; feed the result to :func:`replay_availability_trace`.
    """
    doms = [
        ("node", n * n, mtbf_node_s),
        ("switch", 2 * n * rails, mtbf_switch_s),
        ("link", 2 * n * n * rails, mtbf_link_s),
    ]
    doms = [(k, ents, mtbf) for k, ents, mtbf in doms if mtbf > 0]
    if not doms:
        return []
    rng = random.Random(seed ^ 0x5DEECE66D)
    # mean of Weibull(scale a, shape b) is a * Gamma(1 + 1/b): divide it
    # back out so the configured MTBF stays the realized mean
    gamma_corr = math.gamma(1.0 + 1.0 / shape)

    def node_entity(nid: int) -> Tuple[int, int]:
        return (nid // n, nid % n)

    def switch_entity(sid: int) -> Tuple[str, int, int]:
        dim_i, rest = divmod(sid, n * rails)
        group, rail = divmod(rest, rails)
        return ("X" if dim_i == 0 else "Y", group, rail)

    def link_entity(lid: int) -> Tuple[Tuple[int, int], str, int]:
        rest, rail = divmod(lid, rails)
        nid, dim_i = divmod(rest, 2)
        return (node_entity(nid), "X" if dim_i == 0 else "Y", rail)

    to_entity = {
        "node": node_entity, "switch": switch_entity, "link": link_entity,
    }
    records: List[AvailabilityRecord] = []
    p_more = 1.0 - 1.0 / max(1.0, burst_mean)
    for kind, entities, mtbf in doms:
        scale = (mtbf / entities) / gamma_corr
        up: List[int] = list(range(entities))
        repairs: List[Tuple[float, int]] = []   # (up time, entity id)
        t = 0.0
        while True:
            t += rng.weibullvariate(scale, shape)
            if t >= duration_s:
                break
            while repairs and repairs[0][0] <= t:
                _, eid = heapq.heappop(repairs)
                bisect.insort(up, eid)
            batch = 1
            while rng.random() < p_more:
                batch += 1
            up_t = t + max(60.0, rng.expovariate(1.0 / mttr_s))
            for _ in range(min(batch, len(up))):
                eid = up.pop(rng.randrange(len(up)))
                records.append(
                    AvailabilityRecord(
                        kind=kind, entity=to_entity[kind](eid),
                        down_t=t, up_t=up_t,
                    )
                )
                heapq.heappush(repairs, (up_t, eid))
    records.sort(key=lambda r: (r.down_t, r.kind, repr(r.entity)))
    return records
