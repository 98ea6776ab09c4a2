"""repro_torch.obs — the port's own copy of the ``repro.obs`` span API
(tracer, metrics registry, trace validation), in the stdlib only (torch is
imported only for device timing and profiler ranges).

* **Tracing** (``tracer``): a :class:`Tracer` emitting B/E spans, instants
  and counters in the Chrome trace-event JSON format (loads in Perfetto).
  The default everywhere is :data:`NULL_TRACER`, whose methods allocate
  nothing; instrumented paths guard with ``if tracer.enabled:``.
  ``Tracer(device=True)`` also times each span on the card (a CUDA event
  pair on the current stream, resolved by ``device_totals()``).  While a
  ``torch.profiler`` records, every span is also a profiler range of the
  ``cpu_op`` kind, and with no tracer installed the sites emit into one
  process-level ``Tracer(device=True)``, :func:`profiled_tracer`.
* **Metrics** (``metrics``): a :class:`MetricsRegistry` of named counters,
  gauges and histograms; ``Tracer(registry=...)`` feeds ``span.<name>``
  histograms.
* **Validation** (``schema``): :func:`validate_trace` and the catalogs of
  the spans the port emits: :data:`KNOWN_SPANS`, under the reference's
  names, and :data:`PORT_SPANS`, the port's own.

The port emits ``serve.prefill`` and ``serve.decode_step`` around every
``prefill_fn`` / ``decode_fn`` call of ``serve/serve_step.py``, and the
``flow.*`` spans of the network simulator (``core/compiled_flow.py``:
CSR assembly, BFS, the all-to-all and symmetry sweeps, the orbit gather,
demand routing), as the reference does::

    from repro_torch.obs import Tracer, tracing

    with tracing(Tracer(process="serve")) as tracer:
        serve_waves(zoo, arts, params, sched, cache_len)
    tracer.write("serve.json")
    print(tracer.phase_totals()["serve.decode_step"])   # count/total_s/mean_us

Training (``train/train_step.py``, ``models/moe.py``) emits ``train.fwd``,
``train.bwd``, ``train.grad_sum``, ``train.grad_reduce``,
``train.optimizer``, the MoE layer's ``moe.fwd.*`` parts and ``moe.bwd``,
and the ``moe.routing`` counter.  An operator reads each layer's device
time over a long run, without a profiler's stretch of each step::

    with tracing(Tracer(device=True)) as t:
        train_loop(...)
    print(t.device_totals()["moe.bwd"])                 # count/device_ms
    print(t.counter_totals()["moe.routing"])            # assigned/slots/kept

or over any ``torch.profiler`` session, where the spans also sit on the
profiler's host timeline beside the kernels::

    with torch.profiler.profile(...):
        train_loop(...)
    print(profiled_tracer().device_totals())

The repo's lint (``python -m tools.lint``) covers ``src/repro``,
``examples/``, ``benchmarks/`` and ``tools/``, not ``src/repro_torch``:
the span catalogs here are held to the port's sources by
``tests/test_torch_obs.py`` instead.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .schema import (
    KNOWN_SPANS, PORT_SPANS, known_span_names, validate_trace,
)
from .tracer import (
    NULL_SPAN,
    NULL_TRACER,
    NullTracer,
    Tracer,
    get_tracer,
    profiled_tracer,
    profiling,
    set_tracer,
    tracing,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "get_tracer",
    "profiled_tracer",
    "profiling",
    "set_tracer",
    "tracing",
    "KNOWN_SPANS",
    "PORT_SPANS",
    "known_span_names",
    "validate_trace",
]
