"""repro_torch.cluster — the port's own copy of ``repro.cluster``: the MLaaS
cluster scheduler and OCS reconfiguration engine (paper §6.6, §7, Fig. 20).

Composes the single-job primitives (``core.topology``, ``core.mapping``,
``core.availability``, ``core.simulator``) into a discrete-event
simulation of operating a RailX installation: training jobs and latency-SLO
inference services with different shapes and parallelism strategies share
one reconfigurable fabric, and failures are worked around by re-programming
the OCS layer.  The modules, the reference's ``__all__`` and every
scheduling decision are the reference's; all randomness goes through
``random.Random(seed)`` as there, so a trace is the same event sequence in
both packages.  It imports nothing of ``repro``.

What differs:

* **The device.**  The one piece of array work is the flow-model goodput
  of a placement (``metrics.estimate_goodput``): the job's rail network is
  lowered to a ``core.compiled_flow.CompiledNetwork`` and its Table-4
  traffic routed by ``route_demands`` through the hand-written kernels of
  ``kernels/flow`` (``flow_bfs_level``, ``flow_ordered_fold``).
  ``ClusterScheduler(..., device=None)`` resolves its device once, through
  ``device.resolve`` (the card unless the caller passes ``"cpu"``), and
  hands it to its ``GoodputCache``.  Nothing else here holds tensors.  The
  goodput is the reference's float bit for bit on either device.
* **The service model's chip.**  ``serving.ServiceModel`` takes its chip's
  rates as fields (``peak_flops``, ``hbm_bw``, ``link_bw``), carried on
  ``ServingConfig``; their defaults are an H100's (``launch/roofline.py``:
  989 TFLOP/s bf16, 3.35 TB/s HBM3, one 400 Gb/s NIC between nodes).  Its
  SLO figures therefore differ from the reference's by design unless the
  caller passes the reference's chip.

Performance notes (the event loop scales to 128x128 node grids): the hot
state is maintained incrementally — per-row occupancy bitmasks
(``occupancy.OccupancyIndex``), touched-key circuit deltas with per-switch
refcounts (``scheduler._install`` / ``_uninstall``), circuit targets and
goodputs memoized by allocation shape (``reconfig.CircuitShapeCache``,
``metrics.GoodputCache``), and a backlog watermark on the occupancy
``version`` so a job is re-attempted only after the free set changed.  The
reference's ``repro/cluster/__init__.py`` states each invariant.
"""

from .backlog import TieredBacklog
from .events import (
    Event,
    EventQueue,
    JobFinish,
    JobSubmit,
    LinkFail,
    LinkRecover,
    NodeFail,
    NodeRecover,
    QuarantineRelease,
    RateUpdate,
    ReplicaScale,
    SwitchFail,
    SwitchRecover,
)
from .faults import (
    FaultDomain,
    FlapTracker,
    QuarantineConfig,
    irreparable_lines,
    link_hits_circuits,
    synthesize_degraded,
)
from .jobs import (
    JobMapping,
    JobSpec,
    default_plan,
    default_serve_plan,
    make_job,
    model_spec_from_config,
    plan_job_mapping,
)
from .metrics import GoodputCache, RunSegment, TimelineMetrics, estimate_goodput
from .occupancy import OccupancyIndex
from .placement import (
    POLICIES,
    REFERENCE_POLICIES,
    best_fit,
    first_fit,
    gang_scored_fit,
    get_policy,
    partial_refit,
    rail_aware,
)
from .reconfig import (
    CircuitShapeCache,
    ReconfigCostModel,
    ReconfigPlan,
    SwitchPatch,
    TxnConfig,
    apply_plan,
    canonical_allocation,
    diff_circuits,
    job_target_circuits,
    relabel_circuits,
    validate_job_reconfig,
)
from .scheduler import ClusterScheduler
from .serving import (
    InferenceJobSpec,
    Replica,
    ServiceModel,
    ServiceState,
    ServingConfig,
    desired_replicas,
    erlang_c,
    make_service,
    mmc_wait_profile,
    slo_attainment,
)
from .serving_traces import (
    DiurnalProfile,
    cumulative_requests,
    diurnal_rate,
    diurnal_trace,
    iter_diurnal_trace,
    mean_diurnal_rate,
)
from .trace import (
    AvailabilityRecord,
    dump_availability_records,
    fault_domain_trace,
    fig20_trace,
    failure_trace,
    generate_weibull_records,
    iter_failure_trace,
    iter_fault_domain_trace,
    iter_poisson_trace,
    load_availability_records,
    poisson_trace,
    replay_availability_trace,
    replay_trace,
    validate_availability_records,
)

__all__ = [
    "AvailabilityRecord",
    "CircuitShapeCache",
    "ClusterScheduler",
    "DiurnalProfile",
    "Event",
    "EventQueue",
    "FaultDomain",
    "FlapTracker",
    "GoodputCache",
    "InferenceJobSpec",
    "JobFinish",
    "JobMapping",
    "JobSpec",
    "JobSubmit",
    "LinkFail",
    "LinkRecover",
    "NodeFail",
    "NodeRecover",
    "QuarantineConfig",
    "QuarantineRelease",
    "RateUpdate",
    "Replica",
    "ReplicaScale",
    "ServiceModel",
    "ServiceState",
    "ServingConfig",
    "SwitchFail",
    "SwitchRecover",
    "OccupancyIndex",
    "POLICIES",
    "REFERENCE_POLICIES",
    "ReconfigCostModel",
    "ReconfigPlan",
    "RunSegment",
    "SwitchPatch",
    "TieredBacklog",
    "TimelineMetrics",
    "TxnConfig",
    "apply_plan",
    "best_fit",
    "canonical_allocation",
    "cumulative_requests",
    "default_plan",
    "default_serve_plan",
    "desired_replicas",
    "diff_circuits",
    "diurnal_rate",
    "diurnal_trace",
    "dump_availability_records",
    "erlang_c",
    "estimate_goodput",
    "failure_trace",
    "fault_domain_trace",
    "fig20_trace",
    "first_fit",
    "gang_scored_fit",
    "generate_weibull_records",
    "get_policy",
    "irreparable_lines",
    "iter_diurnal_trace",
    "iter_failure_trace",
    "iter_fault_domain_trace",
    "iter_poisson_trace",
    "job_target_circuits",
    "link_hits_circuits",
    "load_availability_records",
    "synthesize_degraded",
    "make_job",
    "make_service",
    "mean_diurnal_rate",
    "mmc_wait_profile",
    "model_spec_from_config",
    "partial_refit",
    "plan_job_mapping",
    "poisson_trace",
    "rail_aware",
    "slo_attainment",
    "relabel_circuits",
    "replay_availability_trace",
    "replay_trace",
    "validate_availability_records",
    "validate_job_reconfig",
]
