"""Structured tracing: Chrome trace-event JSON with a zero-cost default (the
port's own copy of ``repro/obs/tracer.py``; stdlib only).

The ``Tracer`` records *span* (``ph: "B"``/``"E"``), *instant*
(``ph: "i"``) and *counter* (``ph: "C"``) events in the Chrome
trace-event format, so a dump (:meth:`Tracer.write`) loads directly in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  Timestamps
are wall-clock microseconds from ``time.perf_counter_ns`` relative to
tracer construction, strictly monotonic, which makes the trace double as
a per-phase wall-time source (:meth:`Tracer.phase_totals`).

The default tracer everywhere is the module-level :data:`NULL_TRACER`
singleton: ``enabled`` is ``False`` and every method is a no-op that
allocates nothing (``span`` returns one shared context-manager
singleton).  Instrumented paths guard with ``if tracer.enabled:`` so the
disabled cost is one attribute load and a branch per site.

A span times the host: on the card PyTorch returns before the device
finishes, so a span around a launch measures its dispatch unless the
caller waits for the device inside it.  ``Tracer(device=True)`` also
records a CUDA event pair a span on the current stream, at begin and at
end; :meth:`Tracer.device_totals` resolves them once, after one
synchronise, into the stream's time from reaching each span to leaving it.

While a ``torch.profiler`` session records, each span is also a profiler
range (``torch._C._profiler._RecordFunctionFast``: a ``cpu_op`` event on
the host timeline, with no device-side twin, unlike ``record_function``'s
user annotations), and :func:`get_tracer` hands the instrumented sites,
where no tracer is installed, one process-level ``Tracer(device=True)``
(:func:`profiled_tracer`).  With neither, a site's cost is
:func:`get_tracer`'s two checks and its ``if tracer.enabled:``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Callable, Dict, IO, List, Optional, Tuple, Union


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this process (obs
    itself never imports torch: without it, none does)."""
    mod = sys.modules.get("torch.autograd.profiler")
    return mod is not None and getattr(mod, "_is_profiler_enabled", False)


def _profiler_range(name: str):
    """An open ``cpu_op`` profiler range named ``name``."""
    from torch._C._profiler import _RecordFunctionFast

    rf = _RecordFunctionFast(name)
    rf.__enter__()
    return rf


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


def _cuda_event():
    """A timing CUDA event recorded on the current stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _NullSpan:
    """Shared no-op context manager returned by ``NullTracer.span``."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """The zero-allocation disabled tracer (``enabled`` is ``False``).

    All methods are no-ops; ``span`` hands back the shared
    :data:`NULL_SPAN` singleton so even an unguarded ``with`` costs no
    allocation.  Instrumentation sites still guard with
    ``if tracer.enabled:`` so argument construction is skipped entirely.
    """

    __slots__ = ()
    enabled = False

    def begin(self, name: str, cat: str = "repro", **args) -> None:
        return None

    def end(self, name: str, **args) -> None:
        return None

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        return None

    def counter(self, name: str, **values) -> None:
        return None

    def span(self, name: str, cat: str = "repro", **args) -> _NullSpan:
        return NULL_SPAN


NULL_TRACER = NullTracer()


class _Span:
    """Context manager pairing one ``B`` event with its ``E`` event.

    ``set(**args)`` attaches arguments to the closing event (useful for
    results only known at exit) — Perfetto merges B- and E-args per slice.
    """

    __slots__ = ("_tracer", "_name", "_exit_args")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name
        self._exit_args: Optional[Dict[str, object]] = None

    def set(self, **args) -> "_Span":
        if self._exit_args is None:
            self._exit_args = args
        else:
            self._exit_args.update(args)
        return self

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        if self._exit_args is None:
            self._tracer.end(self._name)
        else:
            self._tracer.end(self._name, **self._exit_args)
        return False


class Tracer:
    """Structured trace recorder (Chrome trace-event JSON).

    Thread-aware: every thread that emits through the tracer gets its
    own ``tid`` (the constructing thread is ``tid=1``) and its own
    open-span stack, so worker-thread spans land on separate Perfetto
    tracks and B/E matching stays per-thread.  One lock serializes
    timestamp acquisition with the event append, so the global event
    list is ordered exactly by ``ts`` even under concurrent emission.
    ``registry`` optionally mirrors every closed span into a histogram
    named ``span.<name>`` (microseconds), wiring the trace layer into
    the metrics registry.  ``device`` (where CUDA is available) times
    each span on the current stream as well (:meth:`device_totals`).

    A counter's value may be a callable of no arguments, called when the
    counters are read (:meth:`counter_totals`, :meth:`to_dict`), so that a
    count kept on the device is reduced then and not at the site.
    """

    enabled = True

    def __init__(
        self,
        process: str = "repro",
        registry=None,
        clock_ns: Optional[Callable[[], int]] = None,
        device: bool = False,
    ):
        self.process = process
        self.events: List[Dict[str, object]] = []
        self.registry = registry
        self.device = device and _cuda_available()
        # (name, begin event, end event) of closed spans not yet resolved;
        # resolved: name -> [count, device ms]
        self._pending: List[Tuple[str, Any, Any]] = []
        self._device_ms: Dict[str, List[float]] = {}
        # indices into events of counters holding callables
        self._deferred: List[int] = []
        self._clock_ns = clock_ns or time.perf_counter_ns
        self._t0 = self._clock_ns()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_tid = 1
        self._thread_names: Dict[int, str] = {}
        # per-phase (span name) totals: name -> [count, total_us]
        self._phase: Dict[str, List[float]] = {}
        # the constructing thread claims tid 1
        self._thread_state()

    # -- clock / thread identity --------------------------------------------

    def _ts(self) -> float:
        """Microseconds since tracer construction (monotonic)."""
        return (self._clock_ns() - self._t0) / 1e3

    def _thread_state(self) -> Tuple[int, List[Tuple[str, float]]]:
        """(tid, open-span stack) of the calling thread, allocating a
        fresh tid on this thread's first emission."""
        tls = self._tls
        try:
            return tls.tid, tls.stack
        except AttributeError:
            with self._lock:
                tid = self._next_tid
                self._next_tid += 1
                self._thread_names[tid] = threading.current_thread().name
            tls.tid = tid
            tls.stack = []
            return tid, tls.stack

    # -- event emission -----------------------------------------------------

    def begin(self, name: str, cat: str = "repro", **args) -> None:
        tid, stack = self._thread_state()
        rf = _profiler_range(name) if profiling() else None
        ev = _cuda_event() if self.device else None
        with self._lock:
            ts = self._ts()
            stack.append((name, ts, rf, ev))
            self.events.append({
                "name": name, "cat": cat, "ph": "B", "ts": ts,
                "pid": 1, "tid": tid, "args": args,
            })

    def end(self, name: str, **args) -> None:
        tid, stack = self._thread_state()
        if not stack or stack[-1][0] != name:
            raise ValueError(
                f"unmatched span end {name!r} (open: "
                f"{[entry[0] for entry in stack]!r})"
            )
        with self._lock:
            ts = self._ts()
            _, t_begin, rf, ev = stack.pop()
            if ev is not None:
                self._pending.append((name, ev, _cuda_event()))
            dur = ts - t_begin
            phase = self._phase.get(name)
            if phase is None:
                self._phase[name] = [1, dur]
            else:
                phase[0] += 1
                phase[1] += dur
            if self.registry is not None:
                self.registry.histogram(f"span.{name}").observe(dur)
            self.events.append({
                "name": name, "ph": "E", "ts": ts,
                "pid": 1, "tid": tid, "args": args,
            })
        if rf is not None:
            rf.__exit__(None, None, None)

    def span(self, name: str, cat: str = "repro", **args) -> _Span:
        self.begin(name, cat=cat, **args)
        return _Span(self, name)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        tid, _ = self._thread_state()
        with self._lock:
            # instants join the phase aggregate at zero duration so
            # presence checks see them uniformly
            phase = self._phase.get(name)
            if phase is None:
                self._phase[name] = [1, 0.0]
            else:
                phase[0] += 1
            self.events.append({
                "name": name, "cat": cat, "ph": "i", "ts": self._ts(),
                "pid": 1, "tid": tid, "s": "t", "args": args,
            })

    def counter(self, name: str, **values) -> None:
        tid, _ = self._thread_state()
        with self._lock:
            if any(callable(v) for v in values.values()):
                self._deferred.append(len(self.events))
            self.events.append({
                "name": name, "cat": "counter", "ph": "C", "ts": self._ts(),
                "pid": 1, "tid": tid, "args": values,
            })

    def _resolve(self) -> None:
        """Call the counters' callable values, once each, in order."""
        with self._lock:
            deferred, self._deferred = self._deferred, []
        for i in deferred:
            args = self.events[i]["args"]
            for key, v in args.items():
                if callable(v):
                    args[key] = v()

    # -- aggregation / output -----------------------------------------------

    def span_names(self) -> set:
        """Names of all spans that have closed at least once (plus any
        emitted instants)."""
        return set(self._phase)

    def phase_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-phase wall-time aggregate: span name -> {count, total_s,
        mean_us}.  Instants count with zero duration."""
        return {
            name: {
                "count": int(cnt),
                "total_s": total_us / 1e6,
                "mean_us": total_us / cnt if cnt else 0.0,
            }
            for name, (cnt, total_us) in sorted(self._phase.items())
        }

    def device_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-span device time: name -> {count, device_ms}, each span the
        current stream's time from its begin to its end (its kernels and
        any idle between them).  Synchronises once to resolve the spans
        closed since the last call; empty without device timing."""
        with self._lock:
            pending, self._pending = self._pending, []
        if pending:
            import torch

            torch.cuda.synchronize()
            for name, start, end in pending:
                acc = self._device_ms.setdefault(name, [0, 0.0])
                acc[0] += 1
                acc[1] += start.elapsed_time(end)
        return {
            name: {"count": int(cnt), "device_ms": ms}
            for name, (cnt, ms) in sorted(self._device_ms.items())
        }

    def counter_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-counter sums: name -> {value name: sum over its events}."""
        self._resolve()
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            if ev["ph"] == "C":
                sums = out.setdefault(ev["name"], {})
                for key, v in ev["args"].items():
                    sums[key] = sums.get(key, 0) + v
        return out

    def to_dict(self) -> Dict[str, object]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        self._resolve()
        meta: List[Dict[str, object]] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 1, "ts": 0,
            "args": {"name": self.process},
        }]
        for tid, tname in sorted(self._thread_names.items()):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "ts": 0, "args": {"name": tname},
            })
        return {
            "traceEvents": meta + self.events,
            "displayTimeUnit": "ms",
        }

    def write(self, path_or_file: Union[str, IO[str]]) -> None:
        """Dump the trace as Chrome trace-event JSON."""
        if hasattr(path_or_file, "write"):
            json.dump(self.to_dict(), path_or_file)
        else:
            with open(path_or_file, "w") as f:
                json.dump(self.to_dict(), f)


# ---------------------------------------------------------------------------
# Ambient tracer (module-scope instrumentation points)
# ---------------------------------------------------------------------------

_current: Union[Tracer, NullTracer] = NULL_TRACER
_profiled: Optional[Tracer] = None
_profiled_lock = threading.Lock()


def get_tracer() -> Union[Tracer, NullTracer]:
    """The ambient tracer: the one :func:`set_tracer` / :func:`tracing`
    installed; else, while a ``torch.profiler`` records, the process-level
    ``Tracer(device=True)`` (:func:`profiled_tracer`); else ``NULL_TRACER``.
    The instrumented sites pick their tracer up from here at each call."""
    if _current is NULL_TRACER and profiling():
        return _profiled or _new_profiled()
    return _current


def _new_profiled() -> Tracer:
    global _profiled
    with _profiled_lock:
        if _profiled is None:
            _profiled = Tracer(process="profiler", device=True)
        return _profiled


def profiled_tracer() -> Optional[Tracer]:
    """The process-level tracer that took the spans and counters emitted
    while a ``torch.profiler`` recorded and no tracer was installed (None
    if nothing was): read it after the profiled work, e.g.
    ``profiled_tracer().device_totals()``."""
    return _profiled


def set_tracer(tracer: Optional[Union[Tracer, NullTracer]]) -> None:
    """Install ``tracer`` as the ambient tracer (``None`` resets)."""
    global _current
    _current = tracer if tracer is not None else NULL_TRACER


class tracing:
    """Context manager scoping the ambient tracer::

        with tracing(Tracer()) as t:
            serve_waves(zoo, arts, params, sched, cache_len)
        t.write("out.json")
    """

    def __init__(self, tracer: Union[Tracer, NullTracer]):
        self.tracer = tracer
        self._prev: Union[Tracer, NullTracer] = NULL_TRACER

    def __enter__(self) -> Union[Tracer, NullTracer]:
        self._prev = get_tracer()
        set_tracer(self.tracer)
        return self.tracer

    def __exit__(self, *exc) -> bool:
        set_tracer(self._prev)
        return False
