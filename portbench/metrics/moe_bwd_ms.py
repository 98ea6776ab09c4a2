"""moe_bwd_ms: device ms a step in the port's ``moe.bwd`` spans: each MoE
layer's backward, routed and shared, from the gradient reaching
``moe_ffn``'s output to it leaving its input; remat's recomputation is
outside it. Each span's time is the CUDA event pair it records on the
current stream while the profiler of a ``--trace 1`` run records, read from
the process-level tracer (``repro_torch.obs.profiled_tracer``); None where
the program has no such tracer or the span never ran."""

from repro_torch import obs


def read(record):
    tracer = getattr(obs, "profiled_tracer", lambda: None)()
    if record.trace is None or tracer is None:
        return None
    span = tracer.device_totals().get("moe.bwd")
    return None if span is None else span["device_ms"] / record.trace.steps
