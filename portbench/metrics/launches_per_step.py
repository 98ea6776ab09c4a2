"""launches_per_step: the CUDA kernels of the profiled steps, counted in
the device trace, a step."""


def read(record):
    if record.trace is None or not record.trace.ops:
        return None
    return len(record.trace.kernels()) / record.trace.steps
