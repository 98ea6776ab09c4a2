"""The port's span API (``repro_torch/obs``) against ``repro.obs``, its span
catalog against the port's sources, and the serving spans of
``serve/serve_step.py``."""

import itertools
import os
import sys
import threading
import typing

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import obs as ref  # noqa: E402
from repro_torch import obs as port  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.obs.tracer import NULL_SPAN  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    BatchScheduler, Request, make_serve_step, serve_waves,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _nested(obs, tracer):
    with tracer.span("serve.prefill", cat="serve", slots=4):
        tracer.instant("mark", cat="x", at=1)
        with tracer.span("serve.decode_step", cat="serve") as sp:
            sp.set(tokens=4)
            sp.set(done=True)
    tracer.begin("outer", n=2)
    tracer.counter("cache", used=3, free=5)
    tracer.end("outer", ok=1)


def _repeats(obs, tracer):
    for i in range(3):
        with tracer.span("serve.decode_step", cat="serve", step=i):
            pass
        tracer.instant("tick")
    tracer.counter("tokens", n=12)


def _threads(obs, tracer):
    """Two worker threads, one after the other: their own tids and stacks."""
    def work(name):
        with tracer.span(name):
            tracer.instant(f"{name}.in")

    for name in ("a", "b"):
        t = threading.Thread(target=work, args=(name,), name=f"worker-{name}")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    with tracer.span("main"):
        pass


def _unmatched_end(obs, tracer):
    tracer.begin("a")
    with pytest.raises(ValueError, match="unmatched span end"):
        tracer.end("b")
    tracer.end("a")


SCRIPTS = {"nested": _nested, "repeats": _repeats, "threads": _threads,
           "unmatched_end": _unmatched_end}


def _run(obs, script):
    """``script`` on a tracer of ``obs`` with a registry and a clock that
    steps 1500 ns a read; -> (trace, phase totals, registry snapshot, span
    names)."""
    reg = obs.MetricsRegistry()
    tracer = obs.Tracer(process="p", registry=reg, clock_ns=itertools.count(0, 1500).__next__)
    script(obs, tracer)
    return tracer.to_dict(), tracer.phase_totals(), reg.snapshot(), tracer.span_names()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tracer_emits_the_reference_events(name):
    """Fed the same calls on the same clock, the port's tracer emits the
    reference's events (B/E, instants, counters, metadata with one tid per
    thread), phase totals, ``span.<name>`` histograms and span names."""
    got, want = _run(port, SCRIPTS[name]), _run(ref, SCRIPTS[name])
    assert got == want
    port.validate_trace(got[0])


EV = lambda ts, ph, name, tid=1: {"name": name, "ph": ph, "pid": 1, "tid": tid, "ts": ts}  # noqa: E731
TRACES = {
    "empty": [],
    "no_events_key": {"displayTimeUnit": "ms"},
    "span": [EV(0, "B", "a"), EV(1, "E", "a")],
    "nested": [EV(0, "B", "a"), EV(1, "B", "b"), EV(2, "E", "b"), EV(3, "E", "a")],
    "per_thread_stacks": [EV(0, "B", "a", 1), EV(0, "B", "b", 2), EV(1, "E", "a", 1),
                          EV(2, "E", "b", 2)],
    "instants_counters_complete": [EV(0, "i", "x"), EV(1, "I", "y"), EV(2, "C", "c"),
                                   EV(3, "X", "d")],
    "metadata_without_ts": [{"name": "process_name", "ph": "M", "pid": 1, "tid": 1}],
    "missing_field": [{"name": "x", "ph": "B"}],
    "unknown_phase": [EV(0, "Q", "x")],
    "not_monotonic": [EV(5.0, "B", "a"), EV(3.0, "E", "a")],
    "negative_ts": [EV(-1, "i", "x")],
    "bad_ts": [EV("0", "i", "x")],
    "end_without_begin": [EV(1.0, "E", "a")],
    "end_mismatch": [EV(1.0, "B", "a"), EV(2.0, "E", "b")],
    "unterminated": [EV(1.0, "B", "a")],
    "not_an_object": [["B"]],
    "trace_object": {"traceEvents": [EV(0, "B", "a"), EV(1, "E", "a")]},
}


def _validated(obs, trace):
    try:
        return "ok", obs.validate_trace(trace)
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_validate_trace_accepts_and_rejects_as_the_reference(name):
    assert _validated(port, TRACES[name]) == _validated(ref, TRACES[name])


def test_metrics_registry_matches_the_reference():
    """Counters, gauges and histograms (log2 quantiles, the non-positive
    bucket), kind clashes, membership and names, as the reference's."""
    snaps = []
    for obs in (port, ref):
        reg = obs.MetricsRegistry()
        reg.counter("c").inc()
        reg.counter("c").inc(4)
        reg.gauge("g").set(2.5)
        h = reg.histogram("h")
        for x in (0.0, -1.0, 0.3, 3.0, 17.0, 1000.0, 1000.0):
            h.observe(x)
        reg.histogram("empty")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("c")
        snaps.append((reg.snapshot(), reg.names(), "c" in reg, reg.get("nope"),
                      [h.quantile(q) for q in (0.1, 0.5, 0.9, 1.0)]))
    assert snaps[0] == snaps[1]


def test_null_tracer_allocates_nothing():
    """The disabled tracer: no events list, one shared span object, every
    method a no-op; the ambient default is it."""
    t = port.NULL_TRACER
    assert t.enabled is False
    assert t.span("x") is NULL_SPAN
    assert t.span("y", cat="z", a=1) is NULL_SPAN
    with t.span("x") as sp:
        assert sp is NULL_SPAN
        assert sp.set(result=1) is NULL_SPAN
    assert t.begin("x") is None and t.end("x") is None
    assert t.instant("x") is None and t.counter("x", v=1) is None
    assert not hasattr(t, "events") and not hasattr(t, "__dict__")
    assert port.get_tracer() is port.NULL_TRACER
    tracer = port.Tracer()
    with port.tracing(tracer) as active:
        assert active is tracer and port.get_tracer() is tracer
    assert port.get_tracer() is port.NULL_TRACER


def _span_usage():
    """(literal span names, dynamic prefixes) at the tracer call sites of
    ``src/repro_torch``, found by the repo lint's own extractor (the lint's
    roots do not cover the port); the tracer package itself is left out, as
    the lint leaves out ``src/repro/obs``."""
    sys.path.insert(0, ROOT)
    try:
        from tools.lint import discover_files, parse_modules
        from tools.lint.passes.tracer_discipline import collect_span_usage
    finally:
        sys.path.remove(ROOT)
    files = [f for f in discover_files(ROOT, ("src/repro_torch",))
             if os.sep + os.path.join("repro_torch", "obs") + os.sep not in f]
    modules, errors = parse_modules(ROOT, files)
    assert not errors, [e.format() for e in errors]
    return collect_span_usage(modules)


def test_every_port_span_is_cataloged_and_none_is_dead():
    """Every span name the port's sources emit is in ``KNOWN_SPANS`` or
    ``PORT_SPANS``, every catalog entry is emitted somewhere, and
    ``KNOWN_SPANS`` is the reference's.
    The scheduler's ``event.*`` spans are named from the event's class, so
    the extractor sees their prefix: the catalog holds one a class of
    ``cluster/events.py``."""
    from repro_torch.cluster import events

    literals, prefixes = _span_usage()
    catalog = port.known_span_names()
    assert prefixes == {"event."}
    classes = {f"event.{c.__name__}" for c in typing.get_args(events.Event)}
    assert {n for n in catalog if n.startswith("event.")} == classes
    assert literals | classes == catalog and not literals & classes
    assert port.KNOWN_SPANS == ref.KNOWN_SPANS


def test_the_port_catalog_holds_every_name_the_reference_lacks():
    """``PORT_SPANS`` holds exactly the names the port's sources emit that
    the reference's catalog lacks, apart from it; ``known_span_names``
    covers both; no port span takes a name of the labels
    ``portbench/trace.py`` patches round the port's functions (their
    device time would be counted twice)."""
    sys.path.insert(0, ROOT)
    try:
        from portbench.trace import LABELS
    finally:
        sys.path.remove(ROOT)
    literals, _ = _span_usage()
    ref_names = ref.known_span_names()
    port_names = frozenset(n for names in port.PORT_SPANS.values() for n in names)
    assert literals - ref_names == port_names
    assert not port_names & ref_names
    assert port.known_span_names() == ref_names | port_names
    assert not port_names & {label for fns in LABELS.values() for label in fns.values()}


FLOW_SPANS = ("flow.csr_assemble", "flow.bfs", "flow.alltoall_counts", "flow.route",
              "flow.symmetry_sweep", "flow.orbit_gather")


def _flow_run():
    """Both sweeps, a routing pass and a canonical build of the port's flow
    engine on the CPU."""
    from repro_torch.core import compiled_flow as cf

    cn = cf.build_compiled_railx_hyperx(4, 2, 2.0, device="cpu")
    return (cf.alltoall_throughput_compiled(cn, 8.0), cf.symmetric_alltoall_throughput(cn, 8.0),
            cf.route_demands(cn, {(0, 9): 1.0, (3, 40): 2.0}, 2).tolist())


def test_flow_engine_emits_the_references_spans():
    """Under ``tracing`` the port's flow engine emits every ``flow.*`` span of
    the reference's catalog but ``goodput.estimate`` (cat ``flow``, the orbit
    gather nested in the symmetry sweep), in a trace that validates; with a
    disabled tracer it never touches it and gives the same results."""
    tracer = port.Tracer(process="flow")
    with port.tracing(tracer):
        traced = _flow_run()
    assert tracer.span_names() == set(FLOW_SPANS)
    begins = [e for e in tracer.events if e["ph"] == "B"]
    assert {e["cat"] for e in begins} == {"flow"}
    marks = [(e["ph"], e["name"]) for e in tracer.events
             if e["name"] in ("flow.symmetry_sweep", "flow.orbit_gather")]
    assert marks == [("B", "flow.symmetry_sweep"), ("B", "flow.orbit_gather"),
                     ("E", "flow.orbit_gather"), ("E", "flow.symmetry_sweep")]
    totals = tracer.phase_totals()
    assert totals["flow.csr_assemble"]["count"] == 1 and totals["flow.route"]["count"] == 1
    assert port.validate_trace(tracer.to_dict())["spans"] == len(begins)
    with port.tracing(_StrictDisabledTracer()):
        assert _flow_run() == traced


class _StrictDisabledTracer:
    """A disabled tracer whose every emit raises: tracing off must call
    straight through."""

    enabled = False

    def __getattr__(self, name):
        raise AssertionError(f"{name} used while tracing is off")


def _serve(tracer, n_requests=6, prompt=5, max_new=3):
    zoo = get_model(get_smoke_config("qwen3-8b"))
    params = zoo.init(0, device="cpu")
    arts = make_serve_step(zoo, device="cpu")
    calls = {"prefill": 0, "decode": 0}

    def counted(kind, fn):
        def call(*args):
            calls[kind] += 1
            return fn(*args)
        return call

    import dataclasses

    arts = dataclasses.replace(arts, prefill_fn=counted("prefill", arts.prefill_fn),
                               decode_fn=counted("decode", arts.decode_fn))
    sched = BatchScheduler(slots=4, eos_id=-1)
    rng = np.random.RandomState(0)
    for i in range(n_requests):
        sched.submit(Request(rid=i, prompt=rng.randint(2, zoo.cfg.vocab, prompt), max_new=max_new))
    with port.tracing(tracer):
        waves = serve_waves(zoo, arts, params, sched, 16, device="cpu")
    return waves, calls


def test_serve_waves_emits_one_span_per_step_call():
    """One-device ``serve_waves`` under ``tracing``: one ``serve.prefill``
    span a ``prefill_fn`` call and one ``serve.decode_step`` span a
    ``decode_fn`` call (cache fills included), cat ``serve``, and a trace
    that validates."""
    tracer = port.Tracer(process="serve")
    waves, calls = _serve(tracer)
    assert calls["prefill"] == len(waves) == 2
    assert calls["decode"] == sum(1 + w.decode_steps for w in waves) == 6
    totals = tracer.phase_totals()
    assert totals["serve.prefill"]["count"] == calls["prefill"]
    assert totals["serve.decode_step"]["count"] == calls["decode"]
    assert set(totals) == {"serve.prefill", "serve.decode_step"}
    begins = [e for e in tracer.events if e["ph"] == "B"]
    assert {e["cat"] for e in begins} == {"serve"}
    assert port.validate_trace(tracer.to_dict())["spans"] == calls["prefill"] + calls["decode"]


def test_serve_waves_calls_straight_through_with_tracing_off():
    """With a disabled tracer the steps never touch it, and answer the same
    tokens as a traced run."""
    waves, calls = _serve(_StrictDisabledTracer())
    traced, _ = _serve(port.Tracer())
    assert calls == {"prefill": 2, "decode": 6}
    assert [[r.generated for r in w.requests] for w in waves] == \
        [[r.generated for r in w.requests] for w in traced]
