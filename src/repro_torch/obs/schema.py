"""Minimal Chrome trace-event schema validation (the port's own copy of
``repro/obs/schema.py``; stdlib only).

``validate_trace`` checks the structural invariants a Perfetto-loadable
trace must satisfy, so a broken instrumentation point (an unterminated
span, an event missing required fields, a non-monotonic clock) fails
loudly instead of producing a trace the viewer silently mis-renders.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple, Union

_PHASES = {"B", "E", "i", "I", "C", "M", "X"}
_REQUIRED = ("name", "ph", "pid", "tid")

# Catalog of span names the port's instrumentation points emit, by layer,
# under the reference's names (``repro/obs/schema.py``).  Documentary for
# validate_trace (unknown names are not an error), but ``known_span_names()``
# lets tools and tests enumerate what a fully traced run can contain, and
# ``tests/test_torch_obs.py`` checks that every name emitted in
# ``src/repro_torch`` is here or in ``PORT_SPANS`` and that no name in
# either is dead.
KNOWN_SPANS: Dict[str, Tuple[str, ...]] = {
    # cluster/scheduler.py: one span per scheduler event class (events.Event)
    "scheduler": (
        "event.JobSubmit",
        "event.JobFinish",
        "event.NodeFail",
        "event.NodeRecover",
        "event.SwitchFail",
        "event.SwitchRecover",
        "event.LinkFail",
        "event.LinkRecover",
        "event.QuarantineRelease",
        "event.RateUpdate",
        "event.ReplicaScale",
        "placement.attempt",
        "backlog.drain",
        "preempt.select",
    ),
    "serving": (
        "serving.autoscale",     # autoscaler decision on a rate sample
        "serving.place",         # replica placement attempt
    ),
    "serve": (
        "serve.prefill",         # one prefill_fn call (serve_step)
        "serve.decode_step",     # one decode_fn call (serve_step)
    ),
    "launch": (
        "roofline.parse",        # one traced step's count (launch/roofline.py)
    ),
    "ocs": (
        "ocs.apply",
        "ocs.revert",
        "ocs.synthesize",
        "ocs.txn_apply",         # two-phase transactional apply (TxnConfig)
        "ocs.txn_rollback",      # retry-exhausted txn undoing its patches
    ),
    "fault": (
        "fault.repair",          # in-place degraded re-synthesis succeeded
        "fault.restore",         # healed rails reprogrammed after a recover
        "fault.partial_migrate", # dead-line-only move (ladder rung 2)
    ),
    # core/compiled_flow.py, and the goodput of a placement (cluster/)
    "flow": (
        "goodput.estimate",
        "flow.csr_assemble",
        "flow.bfs",
        "flow.alltoall_counts",
        "flow.route",
        "flow.symmetry_sweep",
        "flow.orbit_gather",
    ),
}


# The port's own spans, which the reference has no name for, by layer; kept
# apart so that ``KNOWN_SPANS`` stays the reference's catalog.  None may take
# a name of the labels ``portbench/trace.py`` patches round the port's
# functions (``moe.route``, ``optimizer.apply``, ...): those labels' device
# time would then be counted twice.
PORT_SPANS: Dict[str, Tuple[str, ...]] = {
    # train/train_step.py: step_fn
    "train": (
        "train.fwd",             # one microbatch's zoo.loss
        "train.bwd",             # its loss.backward(), remat's recompute in it
        "train.grad_sum",        # the f32 microbatch sum: fill, each add, the division
        "train.grad_reduce",     # a mesh step's gradient collectives and norm
        "train.optimizer",       # optimizer.apply
    ),
    # models/moe.py, on every path (dense, EP, global)
    "moe": (
        "moe.fwd.route",         # _route
        "moe.fwd.dispatch",      # _dispatch
        "moe.fwd.experts",       # _expert_ffn
        "moe.fwd.combine",       # _combine
        "moe.fwd.shared",        # the shared experts' SwiGLU
        "moe.bwd",               # the layer's backward, remat's recompute outside it
    ),
    # (and the counter moe.routing, one a _route call: assigned = T * K,
    # slots = E * C, kept = sum over experts of min(count, C); and
    # optimizer.fused, one an optimizer.apply call on the card: leaves,
    # elements, kernel launches)
}

def known_span_names() -> frozenset:
    """Every span name in :data:`KNOWN_SPANS` and :data:`PORT_SPANS`,
    flattened."""
    return frozenset(n for catalog in (KNOWN_SPANS, PORT_SPANS)
                     for names in catalog.values() for n in names)


def validate_trace(
    trace: Union[Mapping, Iterable[Mapping]],
) -> Dict[str, int]:
    """Validate a trace (the ``to_dict()`` object or a raw event list).

    Checks, raising ``ValueError`` on the first violation:

    * every event carries ``name``/``ph``/``pid``/``tid``, a known
      phase, and (except metadata) a numeric non-negative ``ts``;
    * per ``(pid, tid)``, timestamps are non-decreasing in emission
      order (the tracer clock is monotonic — a violation means events
      were reordered or the clock is broken);
    * ``B``/``E`` span events nest properly: every ``E`` closes the most
      recent open ``B`` of the same name, and no span stays open.

    Returns summary stats: ``{"events": N, "spans": S, "instants": I,
    "counters": C}``.
    """
    if isinstance(trace, Mapping):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace object has no 'traceEvents' list")
    else:
        events = list(trace)
    last_ts: Dict[Tuple[object, object], float] = {}
    open_spans: Dict[Tuple[object, object], List[str]] = {}
    spans = instants = counters = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, Mapping):
            raise ValueError(f"event {i} is not an object: {ev!r}")
        for field in _REQUIRED:
            if field not in ev:
                raise ValueError(f"event {i} missing field {field!r}: {ev!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} has bad ts {ts!r}")
        key = (ev["pid"], ev["tid"])
        prev = last_ts.get(key)
        if prev is not None and ts < prev:
            raise ValueError(
                f"event {i} ts {ts} not monotonic on {key} (prev {prev})"
            )
        last_ts[key] = ts
        if ph == "B":
            open_spans.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = open_spans.get(key)
            if not stack:
                raise ValueError(
                    f"event {i}: span end {ev['name']!r} with no open span"
                )
            if stack[-1] != ev["name"]:
                raise ValueError(
                    f"event {i}: span end {ev['name']!r} does not match "
                    f"open span {stack[-1]!r}"
                )
            stack.pop()
            spans += 1
        elif ph in ("i", "I"):
            instants += 1
        elif ph == "C":
            counters += 1
        elif ph == "X":
            spans += 1
    for key, stack in open_spans.items():
        if stack:
            raise ValueError(f"unterminated span(s) on {key}: {stack!r}")
    return {
        "events": len(events),
        "spans": spans,
        "instants": instants,
        "counters": counters,
    }
