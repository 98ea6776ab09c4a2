"""repro_torch.obs — the port's own copy of the ``repro.obs`` span API
(tracer, metrics registry, trace validation), in the stdlib only.

* **Tracing** (``tracer``): a :class:`Tracer` emitting B/E spans, instants
  and counters in the Chrome trace-event JSON format (loads in Perfetto).
  The default everywhere is :data:`NULL_TRACER`, whose methods allocate
  nothing; instrumented paths guard with ``if tracer.enabled:``.
* **Metrics** (``metrics``): a :class:`MetricsRegistry` of named counters,
  gauges and histograms; ``Tracer(registry=...)`` feeds ``span.<name>``
  histograms.
* **Validation** (``schema``): :func:`validate_trace` and the catalog of the
  spans the port emits, :data:`KNOWN_SPANS`, under the reference's names.

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

The repo's lint (``python -m tools.lint``) covers ``src/repro``,
``examples/``, ``benchmarks/`` and ``tools/``, not ``src/repro_torch``:
the span catalog here is held to the port's sources by
``tests/test_torch_obs.py`` instead.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .schema import KNOWN_SPANS, known_span_names, validate_trace
from .tracer import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    get_tracer,
    set_tracer,
    tracing,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "tracing",
    "KNOWN_SPANS",
    "known_span_names",
    "validate_trace",
]
