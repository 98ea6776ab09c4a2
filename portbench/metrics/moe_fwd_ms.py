"""moe_fwd_ms: device ms a step under the labels ``portbench.trace`` puts
round the MoE layer's route, dispatch, experts and combine (the forward,
remat's recomputation included; the backward's kernels are not labelled)."""

from portbench.trace import LABELS

PARTS = tuple(LABELS["repro_torch.models.moe"].values())


def read(record):
    t = record.trace
    if t is None or not any(p in t.label_us for p in PARTS):
        return None
    return sum(t.label_us.get(p, 0.0) for p in PARTS) / 1e3 / t.steps
