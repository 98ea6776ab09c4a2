"""flash_roofline: the flash kernels' calls in the profiled steps, the sum
of their bounds (``portbench.counts.flash_bound_s``) over the sum of their
device time, in %."""

from portbench.trace import flash_roofline


def read(record):
    return flash_roofline(record.trace) if record.trace is not None else None
