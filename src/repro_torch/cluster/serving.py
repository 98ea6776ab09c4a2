"""Serving workload class for the cluster scheduler (paper §7 MLaaS).

The port's own copy of ``repro/cluster/serving.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.  One
departure: the service model prices decode on the chip whose rates it is
given (``ServiceModel.peak_flops`` / ``hbm_bw`` / ``link_bw``, carried on
``ServingConfig``), by default an H100's from ``launch/roofline.py``
(``PEAK_FLOPS`` 989 TFLOP/s bf16, ``HBM_BW`` 3.35 TB/s, ``NIC_BW`` 50 GB/s:
one 400 Gb/s NIC as the inter-node link).  Given the reference's chip
rates, every figure is the reference's.

RailX's flexibility argument is that one reconfigurable fabric hosts
training *and* latency-bound inference.  This module models the serving
side as a digital twin: an :class:`InferenceJobSpec` names a model from
the ``configs`` registry, a per-request latency SLO, and a replica
shape (a ``ParallelismPlan`` whose footprint the §5 mapping solver
turns into a node rectangle, exactly like a training job).  Replicas
are placed through the scheduler's normal placement + OCS patch-plan
machinery and contend with training jobs for nodes.

**ServiceModel** — serving goodput does not come from the flow model:
decode is a latency roofline, not a bandwidth-saturation problem.  The
per-replica token rate is assembled from roofline terms (the chip's
``peak_flops`` / ``hbm_bw`` / ``link_bw`` and ``launch/roofline.py``'s
``model_decode_flops``):

* compute: ``2 * N_active * batch`` FLOPs per decode step over the
  model-sharded chips;
* memory: weight shard + KV-cache read per step at ``hbm_bw`` (decode
  is usually memory-bound, as on real accelerators);
* intra-node collectives (TP all-reduces) at the §3.3.5 mesh multiple;
* **inter-node collectives** (pipeline activation hops, data-parallel
  token routing, MoE expert dispatch) and the disaggregated-prefill
  KV-cache stream at ``link_bw * rail_factor`` — ``rail_factor`` is the
  placed allocation's surviving-rail bandwidth from
  ``faults.synthesize_degraded``, so degraded/repaired circuits
  visibly slow decode and (through the queue) hurt SLO attainment.

**Queue** — each service is an M/M/c queue whose servers are replica
batch slots (continuous batching: a replica serves ``batch_size``
requests concurrently, each at ``1/request_service_s``).  The queue is
evaluated analytically (Erlang-C) per piecewise-constant rate interval
driven by ``serving_traces`` samples; SLO attainment is the fraction
of requests whose queue wait + service time meets ``slo_p99_s``.

**Autoscaler** — default-off like every policy flag
(``ServingConfig.autoscale``): on each rate sample it sizes the
service to ``rate / (replica_rate * target_utilization)``, scaling up
immediately and down only after ``scale_down_ticks`` consecutive
low-rate samples, by emitting :class:`~repro_torch.cluster.events.ReplicaScale`
events.  ``preempt_training`` lets a failed replica placement evict
strictly-lower-tier training jobs (serving preemption priority) and
``headroom_nodes`` keeps a free-node reserve that training placements
may not consume (headroom reservation) — the two knobs of the SLO
policy engine's training-vs-serving capacity trade.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..configs.registry import get_config
from ..core.availability import JobAllocation
from ..core.mapping import ParallelismPlan, WorkloadShape
from ..launch.roofline import HBM_BW, NIC_BW, PEAK_FLOPS, model_decode_flops
from .jobs import JobSpec, default_serve_plan
from .reconfig import CircuitMap

# RailX intra-node 2D-mesh bandwidth multiple (paper §3.3.5): a property of
# the node's wiring, not of the chip
INTRA_NODE_K = 4.0

# relative slack when deciding a rate saturates the service: arrival at
# (or beyond) capacity has no steady state, the interval counts as
# overloaded and its requests as missed
_STABILITY_EPS = 1e-9


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InferenceJobSpec:
    """One latency-SLO inference service hosted on the cluster."""

    service_id: int
    name: str                     # display name, e.g. "qwen3-8b/chat"
    arch: str                     # configs registry key
    slo_p99_s: float              # per-request latency SLO (p99)
    plan: ParallelismPlan         # replica shape (per-replica parallelism)
    shape: WorkloadShape          # decode workload shape (mapping solver input)
    batch_size: int = 8           # continuous-batching slots per replica
    tokens_per_request: float = 256.0
    prompt_tokens: float = 1024.0  # prefill context streamed to the replica
    min_replicas: int = 1
    max_replicas: int = 8
    initial_replicas: int = 1
    tier: int = 2                 # serving preemption priority (vs job tiers)

    def to_job_spec(self) -> JobSpec:
        """Bridge to the mapping solver / victim selection: a pseudo
        training job with this service's arch, plan, shape, and tier.
        Negative job ids keep replicas out of the training record space."""
        return JobSpec(
            job_id=-1 - self.service_id,
            name=f"{self.name}/replica",
            arch=self.arch,
            plan=self.plan,
            shape=self.shape,
            service_s=math.inf,
            tier=self.tier,
        )


def make_service(
    service_id: int,
    arch: str,
    *,
    slo_p99_s: float = 2.0,
    plan: Optional[ParallelismPlan] = None,
    seq_len: int = 4096,
    batch_size: int = 8,
    tokens_per_request: float = 256.0,
    prompt_tokens: float = 1024.0,
    min_replicas: int = 1,
    max_replicas: int = 8,
    initial_replicas: int = 1,
    tier: int = 2,
) -> InferenceJobSpec:
    """Service construction helper (mirrors ``jobs.make_job``)."""
    plan = plan or default_serve_plan(arch)
    shape = WorkloadShape(micro_batch=1, num_micro_batches=1, seq_len=seq_len)
    return InferenceJobSpec(
        service_id=service_id,
        name=f"{arch}/serve",
        arch=arch,
        slo_p99_s=slo_p99_s,
        plan=plan,
        shape=shape,
        batch_size=batch_size,
        tokens_per_request=tokens_per_request,
        prompt_tokens=prompt_tokens,
        min_replicas=min_replicas,
        max_replicas=max_replicas,
        initial_replicas=initial_replicas,
        tier=tier,
    )


# ---------------------------------------------------------------------------
# Roofline-backed service model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Tokens/s per replica from roofline terms (see module docstring), on
    the chip whose rates are ``peak_flops`` (FLOP/s), ``hbm_bw`` (bytes/s)
    and ``link_bw`` (bytes/s of one inter-node link)."""

    param_bytes: float            # total weight bytes (dtype-scaled)
    active_params: float          # params touched per token (MoE-aware)
    d_model: int
    layers: int
    kv_token_bytes: float         # KV bytes appended per token (all layers)
    shard_chips: int              # tp * pp: chips sharing the weight shard
    dp_groups: int                # dp * cp: independent decode slices
    inter_hops: int               # node-crossing activation hops per token
    dtype_bytes: float = 2.0
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = NIC_BW

    @classmethod
    def for_spec(
        cls, spec: InferenceJobSpec, peak_flops: float = PEAK_FLOPS,
        hbm_bw: float = HBM_BW, link_bw: float = NIC_BW,
    ) -> "ServiceModel":
        cfg = get_config(spec.arch)
        plan = spec.plan
        dp_groups = max(1, plan.dp * plan.cp)
        # node-crossing stages per generated token: pipeline activation
        # hops (there and back through microbatch return), data-parallel
        # token routing, and MoE expert dispatch+combine when the plan
        # spreads experts
        moe_hops = (
            2 * cfg.moe.top_k if (cfg.moe is not None and plan.ep > 1) else 0
        )
        inter_hops = 2 * max(0, plan.pp - 1) + (2 if dp_groups > 1 else 0)
        inter_hops += moe_hops
        head_dim = cfg.resolved_head_dim
        return cls(
            param_bytes=2.0 * cfg.param_count(),
            active_params=cfg.active_param_count(),
            d_model=cfg.d_model,
            layers=cfg.num_layers,
            kv_token_bytes=2.0 * cfg.kv_heads * head_dim * 2.0 * cfg.num_layers,
            shard_chips=max(1, plan.tp * plan.pp),
            dp_groups=dp_groups,
            inter_hops=inter_hops,
            peak_flops=peak_flops,
            hbm_bw=hbm_bw,
            link_bw=link_bw,
        )

    def decode_step_s(
        self, batch: int, context_tokens: float, rail_factor: float = 1.0
    ) -> float:
        """Seconds for one decode step of a ``batch``-slot replica."""
        bg = max(1.0, batch / self.dp_groups)   # per-slice batch
        compute_s = model_decode_flops(self.active_params, bg) / (
            self.shard_chips * self.peak_flops
        )
        memory_s = (
            self.param_bytes / self.shard_chips
            + bg * context_tokens * self.kv_token_bytes / self.shard_chips
        ) / self.hbm_bw
        intra_s = (
            4.0 * self.layers * bg * self.d_model * self.dtype_bytes
        ) / (INTRA_NODE_K * self.link_bw)
        inter_s = (
            self.inter_hops * bg * self.d_model * self.dtype_bytes
        ) / (self.link_bw * rail_factor)
        return max(compute_s, memory_s) + intra_s + inter_s

    def kv_stream_s(self, prompt_tokens: float, rail_factor: float = 1.0) -> float:
        """Disaggregated-prefill KV shipping time across the rail fabric."""
        return prompt_tokens * self.kv_token_bytes / (self.link_bw * rail_factor)

    def tokens_per_s(
        self, batch: int, context_tokens: float, rail_factor: float = 1.0
    ) -> float:
        """Aggregate decode throughput of one replica."""
        return batch / self.decode_step_s(batch, context_tokens, rail_factor)

    def request_service_s(
        self, spec: InferenceJobSpec, rail_factor: float = 1.0
    ) -> float:
        """End-to-end service time of one request in a full batch."""
        context = spec.prompt_tokens + spec.tokens_per_request / 2.0
        step = self.decode_step_s(spec.batch_size, context, rail_factor)
        return spec.tokens_per_request * step + self.kv_stream_s(
            spec.prompt_tokens, rail_factor
        )

    def replica_rate_rps(
        self, spec: InferenceJobSpec, rail_factor: float = 1.0
    ) -> float:
        """Steady-state request throughput of one replica (all slots)."""
        return spec.batch_size / self.request_service_s(spec, rail_factor)


# ---------------------------------------------------------------------------
# M/M/c queue figures
# ---------------------------------------------------------------------------


def erlang_c(c: int, offered: float) -> float:
    """P(wait) for an M/M/c queue at offered load ``a = lam/mu < c``.

    Computed through the Erlang-B recurrence (numerically stable for
    large ``c``); returns 1.0 at or beyond saturation.
    """
    if c <= 0:
        raise ValueError(f"need at least one server, got c={c}")
    if offered <= 0.0:
        return 0.0
    if offered >= c:
        return 1.0
    b = 1.0
    for k in range(1, c + 1):
        b = offered * b / (k + offered * b)
    rho = offered / c
    return b / (1.0 - rho * (1.0 - b))


def mmc_wait_profile(
    lam: float, mu: float, c: int
) -> Tuple[float, float, float]:
    """(P(wait), mean wait, p99 wait) for a stable M/M/c queue.

    The waiting-time tail is ``P(W > t) = C * exp(-(c*mu - lam) * t)``,
    so the p99 delay is ``ln(C/0.01) / (c*mu - lam)`` when ``C > 0.01``
    and zero otherwise.
    """
    drain = c * mu - lam
    if drain <= 0.0:
        raise ValueError(f"unstable queue: lam={lam} >= c*mu={c * mu}")
    pc = erlang_c(c, lam / mu)
    mean_wait = pc / drain
    p99 = math.log(pc / 0.01) / drain if pc > 0.01 else 0.0
    return pc, mean_wait, p99


def slo_attainment(lam: float, mu: float, c: int, slo_s: float) -> float:
    """Fraction of requests finishing within ``slo_s`` (wait + service)."""
    service_s = 1.0 / mu
    if slo_s <= service_s:
        return 0.0
    drain = c * mu - lam
    if drain <= 0.0:
        return 0.0
    pc = erlang_c(c, lam / mu)
    att = 1.0 - pc * math.exp(-drain * (slo_s - service_s))
    return min(1.0, max(0.0, att))


def desired_replicas(
    spec: InferenceJobSpec, rate_rps: float, replica_rate: float,
    target_utilization: float,
) -> int:
    """Autoscaler sizing: replicas so each runs at ``target_utilization``."""
    if replica_rate <= 0.0 or target_utilization <= 0.0:
        return spec.min_replicas
    need = rate_rps / (replica_rate * target_utilization)
    want = max(spec.min_replicas, math.ceil(need - 1e-9))
    return min(spec.max_replicas, want)


# ---------------------------------------------------------------------------
# Scheduler-side state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Serving policy knobs (every behavior flag defaults off)."""

    services: Tuple[InferenceJobSpec, ...] = ()
    autoscale: bool = False            # emit ReplicaScale from rate samples
    target_utilization: float = 0.7    # autoscaler per-replica load target
    scale_down_ticks: int = 3          # hysteresis: low samples before shrink
    preempt_training: bool = False     # serving preemption priority
    headroom_nodes: int = 0            # free-node reserve training can't take
    # the chip the service model prices decode on (an H100 by default)
    peak_flops: float = PEAK_FLOPS     # FLOP/s
    hbm_bw: float = HBM_BW             # bytes/s
    link_bw: float = NIC_BW            # bytes/s, one inter-node link

    def model_for(self, spec: InferenceJobSpec) -> ServiceModel:
        """``spec``'s service model on this config's chip."""
        return ServiceModel.for_spec(
            spec, peak_flops=self.peak_flops, hbm_bw=self.hbm_bw,
            link_bw=self.link_bw,
        )


@dataclasses.dataclass
class Replica:
    """One placed replica: its rectangle, circuits, and rail factor."""

    alloc: JobAllocation
    circuits: CircuitMap
    factor: float = 1.0                # surviving-rail bandwidth fraction


@dataclasses.dataclass
class ServiceState:
    """Mutable per-service scheduler state + queue accounting.

    Queue figures integrate piecewise-constant intervals: every event
    that changes the service's rate or capacity first calls
    :meth:`advance_to`, which charges ``[last_t, t]`` at the old state.
    """

    spec: InferenceJobSpec
    model: ServiceModel
    replicas: List[Replica] = dataclasses.field(default_factory=list)
    rate_rps: float = 0.0
    last_t: float = 0.0
    down_ticks: int = 0                # consecutive low-rate autoscale ticks
    # request/time integrals
    requests: float = 0.0              # total arrivals (lam dt)
    attained: float = 0.0              # arrivals meeting the SLO
    wait_request_s: float = 0.0        # sum of expected waits over arrivals
    p99_s_weighted: float = 0.0        # integral of p99 wait over stable time
    stable_s: float = 0.0              # time with a stable queue
    overload_s: float = 0.0            # time at/beyond capacity (or c=0)
    util_s_weighted: float = 0.0       # integral of min(1, lam/capacity)
    observed_s: float = 0.0            # total accounted time
    slot_s: float = 0.0                # integral of serving slots
    degraded_slot_s: float = 0.0       # slot-seconds at rail factor < 1
    # event counters
    scale_ups: int = 0
    scale_downs: int = 0
    scale_failures: int = 0
    fault_evictions: int = 0
    migrations: int = 0
    repairs: int = 0
    preemptions: int = 0
    timeline: List[Tuple[float, int]] = dataclasses.field(default_factory=list)

    def slots(self) -> int:
        return len(self.replicas) * self.spec.batch_size

    def capacity_rps(self) -> float:
        return sum(
            self.model.replica_rate_rps(self.spec, rep.factor)
            for rep in self.replicas
        )

    def healthy_replica_rate(self) -> float:
        return self.model.replica_rate_rps(self.spec, 1.0)

    def mark_replicas(self, t: float) -> None:
        """Record a replicas-over-time sample (on every count change)."""
        n = len(self.replicas)
        if not self.timeline or self.timeline[-1][1] != n:
            self.timeline.append((t, n))

    def advance_to(self, t: float) -> None:
        dt = t - self.last_t
        if dt <= 0.0:
            return
        self.last_t = t
        self.observed_s += dt
        lam = self.rate_rps
        c = self.slots()
        reqs = lam * dt
        self.requests += reqs
        self.slot_s += c * dt
        for rep in self.replicas:
            if rep.factor < 1.0:
                self.degraded_slot_s += self.spec.batch_size * dt
        cap = self.capacity_rps()
        if c == 0 or cap <= 0.0:
            if lam > 0.0:
                self.overload_s += dt
            return
        self.util_s_weighted += dt * min(1.0, lam / cap)
        if lam >= cap * (1.0 - _STABILITY_EPS):
            # no steady state: the interval's requests all miss the SLO
            self.overload_s += dt
            return
        mu = cap / c
        _, mean_wait, p99 = mmc_wait_profile(lam, mu, c)
        self.stable_s += dt
        self.p99_s_weighted += dt * p99
        self.wait_request_s += reqs * mean_wait
        self.attained += reqs * slo_attainment(lam, mu, c, self.spec.slo_p99_s)

    def summary(self) -> Dict[str, object]:
        att = self.attained / self.requests if self.requests > 0 else 1.0
        return {
            "name": self.spec.name,
            "arch": self.spec.arch,
            "slo_p99_s": self.spec.slo_p99_s,
            "requests": round(self.requests, 3),
            "slo_attainment": round(att, 4),
            "mean_queue_wait_s": round(
                self.wait_request_s / self.requests, 4
            ) if self.requests > 0 else 0.0,
            "p99_queue_delay_s": round(
                self.p99_s_weighted / self.stable_s, 4
            ) if self.stable_s > 0 else 0.0,
            "overload_fraction": round(
                self.overload_s / self.observed_s, 4
            ) if self.observed_s > 0 else 0.0,
            "utilization": round(
                self.util_s_weighted / self.observed_s, 4
            ) if self.observed_s > 0 else 0.0,
            "replicas": len(self.replicas),
            "degraded_slot_fraction": round(
                self.degraded_slot_s / self.slot_s, 4
            ) if self.slot_s > 0 else 0.0,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "scale_failures": self.scale_failures,
            "fault_evictions": self.fault_evictions,
            "migrations": self.migrations,
            "repairs": self.repairs,
            "preemptions": self.preemptions,
            "replicas_over_time": [
                [round(ts, 1), n] for ts, n in self.timeline
            ],
        }
