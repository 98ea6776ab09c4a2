"""Flow-level network simulator (paper §6.1.2 adaptation).

The paper evaluates RailX with a cycle-accurate flit simulator (CNSim).  A
cycle-accurate router model is orthogonal to a JAX training framework, so we
implement the standard *flow-level* steady-state model that reproduces the
paper's throughput results (Fig. 14):

  * traffic = a demand matrix over chips (all-to-all, ring-collective, ...);
  * each demand is routed over the topology graph (minimal routing;
    ``num_paths>=2`` adds 2-way load-balanced ECMP via successive
    link-disjoint-ish shortest paths);
  * link load = sum of demand fractions crossing it / link capacity;
  * achievable per-chip throughput = 1 / max_link_load (normalized to the
    per-port injection bandwidth), the classical bottleneck bound the
    paper's Eq. (2)-(4) are derived from;
  * latency is modeled per-hop (10 cycles external / 1 internal, Table 5).

Chips are vertices (node, chip) where node is a topology coordinate and
chip a position in the m x m mesh; intra-node links have capacity k x the
inter-node links (the 2D-mesh-as-virtual-switch of §3.3.5).

The port's own copy of ``repro/core/simulator.py``.  The dict graph
(``FlowNetwork``, ``shortest_paths_multi``, ``max_utilization``) stays
plain Python; routing and the all-to-all sweeps lower it to the port's
``compiled_flow.CompiledNetwork``, whose tensors lie on ``device`` (the
card unless the caller passes ``device="cpu"``) and whose hot loops are
the hand-written kernels of ``kernels/flow``:

* **exact** — ``alltoall_throughput`` counts, for every ordered chip
  pair, the links its seed-identical shortest path crosses (batched BFS
  levels + subtree accumulation), and converts the integer counts into
  the seed engine's sequentially accumulated float loads: the result is
  **bit-identical** to the reference's (and its seed dict engine's).
* **symmetry** — the canonical builders in ``compiled_flow``
  (``build_compiled_railx_hyperx`` / ``build_compiled_torus2d`` /
  ``build_compiled_fattree``) carry a node-translation automorphism
  group; ``symmetric_alltoall_throughput`` routes one representative
  source per automorphism class and reconstructs total per-edge loads
  exactly over the group orbit, turning the O(N²) all-to-all sweep into
  O(N · classes): the paper's >100K-chip operating points (Fig. 14).

The reference's seed engine, ``route_demands_ecmp_reference``, is the
oracle of the port's tests (``tests/test_torch_flow.py``) and is not
copied here.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

Vertex = Hashable
Edge = Tuple[Vertex, Vertex]


@dataclasses.dataclass
class FlowNetwork:
    """Directed capacitated graph; capacities in units of one external link."""

    adj: Dict[Vertex, List[Vertex]] = dataclasses.field(
        default_factory=lambda: defaultdict(list)
    )
    capacity: Dict[Edge, float] = dataclasses.field(default_factory=dict)

    def add_link(self, a: Vertex, b: Vertex, cap: float, bidir: bool = True) -> None:
        if b not in self.adj[a]:
            self.adj[a].append(b)
        self.capacity[(a, b)] = self.capacity.get((a, b), 0.0) + cap
        if bidir:
            if a not in self.adj[b]:
                self.adj[b].append(a)
            self.capacity[(b, a)] = self.capacity.get((b, a), 0.0) + cap

    def vertices(self) -> List[Vertex]:
        return list(self.adj)


# ---------------------------------------------------------------------------
# Routing + load accounting
# ---------------------------------------------------------------------------


def shortest_paths_multi(
    net: FlowNetwork, src: Vertex, dsts: Iterable[Vertex]
) -> Dict[Vertex, List[Vertex]]:
    """BFS tree from src; returns one shortest path per destination."""
    parent: Dict[Vertex, Vertex] = {src: src}
    dq = deque([src])
    want = set(dsts)
    found: Dict[Vertex, List[Vertex]] = {}
    while dq and want:
        u = dq.popleft()
        for v in net.adj[u]:
            if v not in parent:
                parent[v] = u
                dq.append(v)
                if v in want:
                    path = [v]
                    while path[-1] != src:
                        path.append(parent[path[-1]])
                    found[v] = path[::-1]
                    want.discard(v)
    return found


def route_demands_ecmp(
    net: FlowNetwork,
    demands: Dict[Tuple[Vertex, Vertex], float],
    num_paths: int = 1,
    device=None,
) -> Dict[Edge, float]:
    """Load per link routing each demand over up to ``num_paths`` link-
    disjoint-ish shortest paths (successive BFS passes that exclude links
    already used for the same source; each demand splits evenly over the
    paths found).

    Runs on the compiled engine on ``device``; ``num_paths=1`` (the
    default, and the seed engine's actual behavior) is bit-identical to
    the reference's ``route_demands_ecmp_reference``.
    """
    from .compiled_flow import CompiledNetwork, route_demands

    cn = CompiledNetwork.from_flow_network(net, device=device)
    vid = cn.vertex_id
    id_demands = {
        (vid[s], vid[t]): v for (s, t), v in demands.items()
    }
    load = route_demands(cn, id_demands, num_paths=num_paths).cpu()
    edge_src, nbr = cn.edge_src.cpu(), cn.nbr.cpu()
    out: Dict[Edge, float] = {}
    verts = cn.vertex_of
    for e in load.nonzero().flatten().tolist():
        out[(verts[int(edge_src[e])], verts[int(nbr[e])])] = float(load[e])
    return out


def max_utilization(net: FlowNetwork, load: Dict[Edge, float]) -> float:
    worst = 0.0
    for e, l in load.items():
        cap = net.capacity.get(e, 0.0)
        if cap <= 0:
            return float("inf")
        worst = max(worst, l / cap)
    return worst


def alltoall_throughput(
    net,
    chips: Optional[Sequence[Vertex]] = None,
    injection_ports: float = 1.0,
    num_paths: int = 1,
    device=None,
) -> float:
    """Steady-state all-to-all throughput per chip, normalized to
    flits/cycle/chip with the external link = 1 flit/cycle (Fig. 14).

    Each chip injects `injection_ports` flits/cycle spread uniformly over
    all other chips; achievable fraction = 1 / max link utilization; the
    reported figure-of-merit is injection * min(1, 1/max_util).

    ``net`` may be a ``FlowNetwork`` (``chips`` are vertices) or a
    ``compiled_flow.CompiledNetwork`` (``chips`` are vertex ids, default
    all chips).  ``num_paths=1`` runs the exact counting sweep —
    bit-identical to the seed engine; ``num_paths>=2`` routes the full
    demand matrix with load-balanced ECMP (small grids only).  A
    ``FlowNetwork`` is lowered onto ``device`` (the card by default); a
    ``CompiledNetwork`` stays where it lies.
    """
    from .compiled_flow import (
        CompiledNetwork,
        alltoall_throughput_compiled,
        route_demands,
        max_utilization_compiled,
    )

    if isinstance(net, CompiledNetwork):
        cn = net
        chip_ids = None if chips is None else [int(c) for c in chips]
    else:
        cn = CompiledNetwork.from_flow_network(net, device=device)
        if chips is None:
            raise ValueError("chips is required for a FlowNetwork")
        chip_ids = [cn.vertex_id[c] for c in chips]
    if num_paths <= 1:
        return alltoall_throughput_compiled(cn, injection_ports, chips=chip_ids)
    ids = cn.chips().tolist() if chip_ids is None else chip_ids
    Nc = len(ids)
    per_pair = injection_ports / (Nc - 1)
    demands = {
        (int(s), int(t)): per_pair for s in ids for t in ids if s != t
    }
    load = route_demands(cn, demands, num_paths=num_paths)
    util = max_utilization_compiled(cn, load)
    if util <= 0:
        return injection_ports
    return injection_ports * min(1.0, 1.0 / util)


def ring_allreduce_time_cycles(
    p_chips: int,
    volume_flits: float,
    hops_external: int,
    ext_latency: float = 10.0,
    int_latency: float = 1.0,
    hops_internal: int = 0,
    bw_flits_per_cycle: float = 1.0,
) -> float:
    """Cycle-count model consistent with Table 5 defaults, for Fig. 15
    cross-checks: (p-1) steps of latency + serialization."""
    steps = 2 * (p_chips - 1)
    latency = steps * (hops_external * ext_latency + hops_internal * int_latency)
    serial = 2 * (p_chips - 1) / p_chips * volume_flits / bw_flits_per_cycle
    return latency + serial
