"""Workload mapping & bandwidth allocation (paper §5, §A.3 Table 4).

The port's own copy of ``repro/core/mapping.py`` (plain Python on plain
values; no tensors, no device).  It imports nothing of ``repro``.

* ``ParallelismPlan`` holds the 5D hybrid parallelism [T, C, E, D_e, P]
  (Figure 4/12): attention DP D_a = E * D_e.
* ``table4_volumes`` computes per-parallelism communication volume,
  process-group scope, and frequency exactly as §A.3 Table 4.
* ``allocate_bandwidth_static`` solves Eq. (11): split n ports between two
  overlappable communications to minimize total exposed time.
* ``allocate_bandwidth_dynamic`` models §5.2: OCS reconfiguration inside
  the CP->EP gap gives each phase the full physical dimension.
* ``plan_dimension_split`` turns a plan + RailXConfig into DimensionSpecs
  (the "mapping solver" the launcher reads its mesh axes from,
  ``launch/mesh.railx_mesh_from_plan``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Literal, Tuple

from .topology import DimensionSpec, RailXConfig, split_dimensions


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Transformer/MoE model hyperparameters used by Table 4."""

    layers: int               # L
    hidden: int               # H
    intermediate: int         # I (per expert for MoE)
    vocab: int                # V_voc
    heads: int                # h_A
    kv_heads: int             # h_KV
    experts: int = 1          # E_tot (1 = dense)
    top_k: int = 1            # K
    dtype_bytes: int = 2


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    """[T, C, E, D_e, P] with attention DP = E * D_e (paper §5)."""

    tp: int = 1
    cp: int = 1
    ep: int = 1
    dp: int = 1      # D_e, the FFN/expert DP
    pp: int = 1

    @property
    def attention_dp(self) -> int:
        return self.ep * self.dp

    @property
    def total(self) -> int:
        return self.tp * self.cp * self.ep * self.dp * self.pp


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    micro_batch: int          # B
    num_micro_batches: int    # N_B per DP rank
    seq_len: int              # S


@dataclasses.dataclass(frozen=True)
class CommVolume:
    parallelism: str
    pattern: str              # traffic pattern name
    volume_bytes: float       # V per occurrence per chip
    frequency: float          # F occurrences per iteration
    scope: int                # process-group size

    @property
    def total_bytes(self) -> float:
        return self.volume_bytes * self.frequency


def table4_volumes(
    model: ModelSpec, plan: ParallelismPlan, shape: WorkloadShape
) -> Dict[str, CommVolume]:
    """Communication volume/frequency of each parallelism (§A.3 Table 4)."""
    B, NB, S = shape.micro_batch, shape.num_micro_batches, shape.seq_len
    H, Iff, L, P = model.hidden, model.intermediate, model.layers, plan.pp
    K = model.top_k
    d = model.dtype_bytes
    hkv_ratio = model.kv_heads / model.heads
    T, C, E, De = plan.tp, plan.cp, plan.ep, plan.dp
    out: Dict[str, CommVolume] = {}
    # Tensor/sequence parallel: RS + AG per block
    out["tp_attn"] = CommVolume(
        "tp", "reduce_scatter+all_gather", B * S * H * d, 4 * NB * L / P, T
    )
    out["tp_ffn"] = CommVolume(
        "tp", "reduce_scatter+all_gather", B * S * H * K * d, 4 * NB * L / P, T
    )
    # Context parallel: P2P ring of KV blocks
    out["cp"] = CommVolume(
        "cp", "point_to_point", B * S * H * (2 * hkv_ratio) / T * d, 2 * NB * L / P, C
    )
    # Expert parallel: all-to-all dispatch+combine
    out["ep"] = CommVolume(
        "ep", "all_to_all", B * S * H * K / (T * C) * d, 4 * NB * L / P, E
    )
    # Data parallel gradients:
    out["dp_vocab"] = CommVolume(
        "dp", "all_reduce", 2 * H * model.vocab / (T * C) * d, 1, De * E
    )
    out["dp_qkv"] = CommVolume(
        "dp", "all_reduce", (2 + 2 * hkv_ratio) * H * H / T * d, L / P, C * De * E
    )
    out["dp_ffn"] = CommVolume(
        "dp", "all_reduce", 3 * H * Iff / T * d, L / P, C * De
    )
    # Pipeline: P2P activations
    out["pp"] = CommVolume(
        "pp", "point_to_point", B * S * H / (T * C) * d, 2 * NB, P
    )
    return out


# ---------------------------------------------------------------------------
# Static bandwidth allocation (Eq. 10/11)
# ---------------------------------------------------------------------------


def exposed_time(
    volume: float, ports: int, port_bw: float, overlap_compute: float
) -> float:
    """max(T*_comp, V / (ports * bw)): overlapped communication is exposed
    only beyond the concurrent compute time."""
    if ports <= 0:
        return math.inf
    return max(overlap_compute, volume / (ports * port_bw))


def allocate_bandwidth_static(
    v1: float,
    v2: float,
    total_ports: int,
    port_bw: float,
    overlap1: float = 0.0,
    overlap2: float = 0.0,
    objective: Literal["total", "slowest"] = "total",
) -> Tuple[int, int, float]:
    """Eq. (11): choose (n1, n2), n1+n2 = total_ports, minimizing
    max(T*c1, V1/(2 n1 B)) + max(T*c2, V2/(2 n2 B))  (or the slowest)."""
    best = (1, total_ports - 1, math.inf)
    for n1 in range(1, total_ports):
        n2 = total_ports - n1
        t1 = exposed_time(v1, 2 * n1, port_bw, overlap1)
        t2 = exposed_time(v2, 2 * n2, port_bw, overlap2)
        score = t1 + t2 if objective == "total" else max(t1, t2)
        if score < best[2]:
            best = (n1, n2, score)
    return best


def allocate_bandwidth_dynamic(
    v1: float, v2: float, total_ports: int, port_bw: float, switch_gap: float
) -> float:
    """§5.2: if the two communications are separated in time by more than
    the OCS reconfiguration latency, each gets the full dimension."""
    t1 = v1 / (2 * total_ports * port_bw)
    t2 = v2 / (2 * total_ports * port_bw)
    return t1 + t2  # switch hidden inside the gap when gap >= reconfig time


# ---------------------------------------------------------------------------
# Dimension-split planning (the mapping solver feeding the launcher)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MappingResult:
    specs: Tuple[DimensionSpec, ...]
    est_comm_time: float
    notes: str = ""


def plan_dimension_split(
    cfg: RailXConfig,
    model: ModelSpec,
    plan: ParallelismPlan,
    shape: WorkloadShape,
    port_bw: float = 50e9,
) -> MappingResult:
    """Map [T,C,E,De,P] onto RailX dims (paper §3.3.4 / Figure 9 / §5.1).

    TP -> intra-node 2D-mesh (highest volume, highest bandwidth).
    Remaining logical dims are assigned to the two physical rail dimensions
    sorted by communication volume: heaviest+lightest share one physical
    dim, the middle two share the other (the paper's §5.2 pairing rule),
    splitting rails proportionally to sqrt(volume) (bandwidth-optimal for
    summed exposed time).
    """
    if plan.tp > cfg.chips_per_node:
        raise ValueError(
            f"tp={plan.tp} exceeds chips per node {cfg.chips_per_node}"
        )
    vols = table4_volumes(model, plan, shape)
    per_dim = {
        "cp": (plan.cp, vols["cp"].total_bytes, "ring"),
        "ep": (plan.ep, vols["ep"].total_bytes, "all_to_all"),
        "dp": (plan.dp, vols["dp_ffn"].total_bytes + vols["dp_qkv"].total_bytes, "ring"),
        "pp": (plan.pp, vols["pp"].total_bytes, "ring"),
    }
    active = {k: v for k, v in per_dim.items() if v[0] > 1}
    order = sorted(active, key=lambda k: -active[k][1])
    # pairing rule: heaviest with lightest on phys X; middle pair on Y
    assign: Dict[str, str] = {}
    for i, name in enumerate(order):
        if i % 3 == 0:
            assign[name] = "X"
        elif i % 3 == 1:
            assign[name] = "Y"
        else:
            assign[name] = "Y" if i % 2 else "X"
    # re-pair: [0, 3] -> X, [1, 2] -> Y for exactly four dims
    if len(order) == 4:
        assign = {order[0]: "X", order[3]: "X", order[1]: "Y", order[2]: "Y"}
    specs: List[DimensionSpec] = []
    for phys in ("X", "Y"):
        members = [k for k in order if assign.get(k) == phys]
        if not members:
            continue
        weights = [math.sqrt(max(active[k][1], 1.0)) for k in members]
        wsum = sum(weights)
        remaining = cfg.r
        for j, k in enumerate(members):
            rails = (
                remaining
                if j == len(members) - 1
                else max(1, int(round(cfg.r * weights[j] / wsum)))
            )
            remaining -= rails
            scale, _, kind = active[k]
            if kind == "all_to_all" and scale in (4, 6):
                kind = "ring"  # Lemma 3.1 exception: fall back to ring
            specs.append(
                DimensionSpec(name=k, scale=scale, rails=rails,
                              interconnect=kind, phys=phys)  # type: ignore[arg-type]
            )
    split_dimensions(cfg, specs)  # validate
    # crude end-to-end comm estimate: sum exposed per dim
    t = 0.0
    for s in specs:
        vol = active[s.name][1]
        t += vol / max(1, s.bandwidth_ports()) / port_bw
    tp_vol = vols["tp_attn"].total_bytes + vols["tp_ffn"].total_bytes
    t += tp_vol / (cfg.k * 2 * cfg.n * port_bw)
    return MappingResult(tuple(specs), t, notes=f"order={order}")
