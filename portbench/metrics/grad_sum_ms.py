"""grad_sum_ms: device ms a step in the port's ``train.grad_sum`` spans: the
f32 microbatch sum: the accumulator's fill, each microbatch's add into it,
the division by the count; only with more than one microbatch. Each span's
time is the CUDA event pair it records on the current stream while the
profiler of a ``--trace 1`` run records, read from the process-level tracer
(``repro_torch.obs.profiled_tracer``); None where the program has no such
tracer or the span never ran."""

from repro_torch import obs


def read(record):
    tracer = getattr(obs, "profiled_tracer", lambda: None)()
    if record.trace is None or tracer is None:
        return None
    span = tracer.device_totals().get("train.grad_sum")
    return None if span is None else span["device_ms"] / record.trace.steps
