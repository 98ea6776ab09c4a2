"""mfu: a step's model operations (``portbench.counts.train_step_flops``)
over (the mean step time of the window's unprofiled steps x 989 TFLOP/s x
chips), in %.  The step time is the host's clock, so this is
``train_tokens_per_s`` in other units, read again over the traced run's
unprofiled steps: the whole step's share of the peak that bounds every
kernel's claim."""

from portbench import counts


def read(record):
    times = record.unprofiled_step_s()
    if record.trace is None or not times:
        return None
    step_s = sum(times) / len(times)
    return 100.0 * record.flops_per_step / (step_s * counts.PEAK_FLOPS["bfloat16"] * record.chips)
