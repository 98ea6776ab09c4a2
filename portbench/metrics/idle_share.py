"""idle_share: 1 - (the union of the device operations' intervals a
profiled step) / (the mean time of the window's unprofiled steps), in %.
The profiled steps' own host time is longer by the profiler's overhead
(0.35 against 0.27 s a step at moe-train-1k), which would read as idle;
the kernels' intervals are not stretched by it."""


def read(record):
    t = record.trace
    times = record.unprofiled_step_s()
    if t is None or not t.ops or not times:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / t.steps / (sum(times) / len(times)))
