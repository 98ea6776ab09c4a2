"""Job specifications for the MLaaS cluster scheduler (paper §6.6, §7).

The port's own copy of ``repro/cluster/jobs.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

A job = a model from the ``configs`` registry + a ``ParallelismPlan`` +
a ``WorkloadShape`` + a service demand (seconds of compute at full
goodput).  ``plan_job_mapping`` runs the §5 mapping solver once per job
and caches the resulting ``DimensionSpec`` split; the rectangular node
footprint (rows x cols on the RailX node grid) falls out of the split:
dims mapped to the physical Y axis tile node rows, X dims tile node
columns (§3.3.4 — split dimensions tile the physical node grid).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from ..configs.base import ModelConfig
from ..configs.registry import get_config
from ..core.mapping import (
    MappingResult,
    ModelSpec,
    ParallelismPlan,
    WorkloadShape,
    plan_dimension_split,
    table4_volumes,
)
from ..core.topology import RailXConfig


def model_spec_from_config(cfg: ModelConfig) -> ModelSpec:
    """Bridge a registry ``ModelConfig`` to the Table-4 ``ModelSpec``."""
    if cfg.moe is not None:
        experts, top_k, inter = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff
    else:
        experts, top_k, inter = 1, 1, cfg.d_ff
    return ModelSpec(
        layers=cfg.num_layers,
        hidden=cfg.d_model,
        intermediate=inter,
        vocab=cfg.vocab,
        heads=cfg.heads,
        kv_heads=cfg.kv_heads,
        experts=experts,
        top_k=top_k,
    )


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training job submitted to the cluster."""

    job_id: int
    name: str                     # display name, e.g. "qwen3-8b/train_4k"
    arch: str                     # configs registry key
    plan: ParallelismPlan
    shape: WorkloadShape
    service_s: float              # seconds of work at goodput = 1.0
    min_nodes: int = 1            # elastic floor: below this, migrate not shrink
    tier: int = 0                 # SLO/priority tier; higher = more important

    @property
    def chips(self) -> int:
        return self.plan.total


@dataclasses.dataclass(frozen=True)
class JobMapping:
    """The solved placement geometry of a job (before node assignment)."""

    mapping: MappingResult
    rows_req: int                 # node rows needed (product of Y-dim scales)
    cols_req: int                 # node cols needed (product of X-dim scales)

    @property
    def nodes(self) -> int:
        return self.rows_req * self.cols_req


def plan_job_mapping(cfg: RailXConfig, job: JobSpec) -> JobMapping:
    """Run the §5 mapping solver and derive the rectangular footprint.

    X-phys dims tile node columns, Y-phys dims tile node rows.  A plan
    whose node dims collapse to 1 (single-node job) occupies a 1x1 slot.
    """
    model = model_spec_from_config(get_config(job.arch))
    mapping = plan_dimension_split(cfg, model, job.plan, job.shape)
    cols = math.prod(s.scale for s in mapping.specs if s.phys == "X")
    rows = math.prod(s.scale for s in mapping.specs if s.phys == "Y")
    return JobMapping(mapping=mapping, rows_req=max(1, rows), cols_req=max(1, cols))


def job_comm_volumes(job: JobSpec) -> Dict[str, float]:
    """Total Table-4 bytes per iteration keyed by parallelism dim name."""
    model = model_spec_from_config(get_config(job.arch))
    vols = table4_volumes(model, job.plan, job.shape)
    out: Dict[str, float] = {}
    for v in vols.values():
        out[v.parallelism] = out.get(v.parallelism, 0.0) + v.total_bytes
    return out


# ---------------------------------------------------------------------------
# Job construction helpers (the trace generator and examples use these)
# ---------------------------------------------------------------------------

_DEFAULT_PLANS: Dict[str, ParallelismPlan] = {
    # chips_per_node-friendly TP (<= 16), modest node dims
    "qwen3-8b": ParallelismPlan(tp=8, cp=2, ep=1, dp=8, pp=2),
    "paper-llama3-moe": ParallelismPlan(tp=8, cp=2, ep=8, dp=2, pp=2),
    "qwen3-moe-235b-a22b": ParallelismPlan(tp=8, cp=1, ep=8, dp=4, pp=4),
    "whisper-large-v3": ParallelismPlan(tp=4, cp=1, ep=1, dp=8, pp=1),
    "llama3.2-3b": ParallelismPlan(tp=4, cp=1, ep=1, dp=4, pp=2),
    "gemma3-4b": ParallelismPlan(tp=4, cp=2, ep=1, dp=4, pp=1),
    "granite-20b": ParallelismPlan(tp=8, cp=1, ep=1, dp=8, pp=2),
}


def default_plan(arch: str) -> ParallelismPlan:
    if arch in _DEFAULT_PLANS:
        return _DEFAULT_PLANS[arch]
    return ParallelismPlan(tp=4, cp=1, ep=1, dp=4, pp=1)


# serving replicas: much smaller footprints than training (latency-bound
# decode wants a model shard + a couple of data-parallel slices, not a
# cluster-scale dp sweep), but always >= 2 node-crossing slices so the
# ServiceModel's rail-bandwidth term is live and degraded circuits bite
_DEFAULT_SERVE_PLANS: Dict[str, ParallelismPlan] = {
    "qwen3-8b": ParallelismPlan(tp=8, cp=1, ep=1, dp=2, pp=1),
    "paper-llama3-moe": ParallelismPlan(tp=8, cp=1, ep=2, dp=2, pp=1),
    "qwen3-moe-235b-a22b": ParallelismPlan(tp=8, cp=1, ep=4, dp=2, pp=2),
    "whisper-large-v3": ParallelismPlan(tp=4, cp=1, ep=1, dp=2, pp=1),
    "llama3.2-3b": ParallelismPlan(tp=4, cp=1, ep=1, dp=2, pp=1),
    "gemma3-4b": ParallelismPlan(tp=4, cp=1, ep=1, dp=2, pp=1),
    "granite-20b": ParallelismPlan(tp=8, cp=1, ep=1, dp=2, pp=2),
}


def default_serve_plan(arch: str) -> ParallelismPlan:
    """Per-replica parallelism for an inference service on ``arch``."""
    if arch in _DEFAULT_SERVE_PLANS:
        return _DEFAULT_SERVE_PLANS[arch]
    return ParallelismPlan(tp=4, cp=1, ep=1, dp=2, pp=1)


def make_job(
    job_id: int,
    arch: str,
    *,
    plan: Optional[ParallelismPlan] = None,
    seq_len: int = 4096,
    micro_batch: int = 1,
    num_micro_batches: int = 8,
    service_s: float = 3600.0,
    min_nodes: int = 1,
    shape_name: str = "train_4k",
    tier: int = 0,
) -> JobSpec:
    plan = plan or default_plan(arch)
    shape = WorkloadShape(
        micro_batch=micro_batch, num_micro_batches=num_micro_batches, seq_len=seq_len
    )
    return JobSpec(
        job_id=job_id,
        name=f"{arch}/{shape_name}",
        arch=arch,
        plan=plan,
        shape=shape,
        service_s=service_s,
        min_nodes=min_nodes,
        tier=tier,
    )
