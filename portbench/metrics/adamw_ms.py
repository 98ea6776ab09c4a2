"""adamw_ms: device ms a step under the label ``portbench.trace`` puts round
``repro_torch.train.optimizer.apply``."""


def read(record):
    t = record.trace
    if t is None or "optimizer.apply" not in t.label_us:
        return None
    return t.label_us["optimizer.apply"] / 1e3 / t.steps
