"""RailX physical architecture and topology configuration (paper §3.2, §3.3).

The port's own copy of ``repro/core/topology.py`` (plain Python on plain
values; no tensors, no device).  It imports nothing of ``repro``.

Physical model
--------------
* chip level:   m x m chips per node, 2D-mesh of short-reach links, ``n``
  off-package ports per chip edge, on-package bandwidth = k x off-package.
* node level:   r = m*n rails per dimension (X and Y); each rail is a +/-
  port pair on opposite node edges.
* system level: (R/2) x (R/2) nodes in a 2D organization.  Node (i, j)'s
  X-rail ``a`` connects to X-OCS (j, a); Y-rail ``b`` to Y-OCS (i, b)
  (Figure 6(b)).  N = (R/2)^2 m^2 chips, N_s = r*R switches (Eq. 1).

Logical topologies (Table 2) are produced by *configuring* the OCSes:

=============  =======================  ==============  ===================
topology       scalability (chips)      diameter (H_o)  bisection BW/chip
=============  =======================  ==============  ===================
2D-Torus       (R/2)^2 m^2              R               16n/(Rm)
2D-HyperX      (r+1)^2 m^2              2               ~2n/m
Dragonfly      (r+1)(R/2) m^2           3               ~2n/m
=============  =======================  ==============  ===================

``DimensionSpec``/``split_dimensions`` implement §3.3.4 Dimension Splitting:
the r rails of each physical dimension are split into logical rail groups,
each configured as a ring (Torus, unbounded scale) or rail-ring all-to-all
(scale <= rails_in_group + 1), building high-dimensional heterogeneous
topologies such as TP x CP x EP x DP x PP.

Graphs are represented as adjacency dicts ``{node: {neighbor: multiplicity}}``
over *node* coordinates; chip-level graphs expand each node into its m x m
mesh.  networkx is used only for verification utilities.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, List, Literal, Sequence, Tuple

from .hamiltonian import hamiltonian_decomposition, rails_for_all_to_all

Node = Tuple[int, ...]
AdjGraph = Dict[Node, Dict[Node, int]]


# ---------------------------------------------------------------------------
# Hardware description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RailXConfig:
    """Physical parameters of a RailX installation (paper Table in §3.2)."""

    m: int = 4          # chips per node edge (node = m x m 2D-mesh)
    n: int = 4          # off-package optical ports per chip edge
    R: int = 128        # OCS radix (port count)
    k: float = 4.0      # on-package BW multiple over off-package per-port BW
    port_gbps: float = 400.0  # per optical port, one direction

    @property
    def r(self) -> int:
        """Rails per physical dimension (X or Y)."""
        return self.m * self.n

    @property
    def nodes_per_side(self) -> int:
        return self.R // 2

    @property
    def num_nodes(self) -> int:
        return self.nodes_per_side ** 2

    @property
    def chips_per_node(self) -> int:
        return self.m * self.m

    @property
    def num_chips(self) -> int:
        """Eq. (1): N = (R/2)^2 m^2."""
        return self.num_nodes * self.chips_per_node

    @property
    def num_switches(self) -> int:
        """Eq. (1): N_s = r R  (r switches per X/Y group, R/2 groups each,
        2 dimensions: 2 * (R/2) * r = rR)."""
        return self.r * self.R

    def validate(self) -> None:
        if self.m < 1 or self.n < 1:
            raise ValueError("m, n must be positive")
        if self.R % 2:
            raise ValueError("OCS radix R must be even")


TPUV4_CUBE = 4 ** 3


def tpuv4_max_chips(R: int, m: int = 4) -> int:
    """TPUv4-style OCS 3D-Torus scale: N = (R/2) m^3 (§3.2)."""
    return (R // 2) * m ** 3


# ---------------------------------------------------------------------------
# Dimension splitting (§3.3.4)
# ---------------------------------------------------------------------------

Interconnect = Literal["ring", "all_to_all"]


@dataclasses.dataclass(frozen=True)
class DimensionSpec:
    """One logical dimension carved out of a physical rail dimension."""

    name: str                 # e.g. "ep", "dp", "cp", "pp"
    scale: int                # number of positions along this dimension
    rails: int                # rails allocated from the physical dimension
    interconnect: Interconnect = "ring"
    phys: Literal["X", "Y"] = "X"

    def max_scale(self, R: int) -> int:
        if self.interconnect == "all_to_all":
            # scale s needs rails_for_all_to_all(s) rails and s <= R/2 nodes
            return min_scale_bound_a2a(self.rails, R)
        return R // 2  # ring scale bounded by nodes per side

    def bandwidth_ports(self) -> int:
        """Ports usable concurrently per node in this dimension (each rail
        is a +/- pair => 2 port-ends per rail)."""
        return 2 * self.rails


def min_scale_bound_a2a(rails: int, R: int) -> int:
    """Max all-to-all scale constructible from ``rails`` rails (Lemma 3.1):
    odd s uses (s-1)/2 bidirectional rings; even s uses s-1 directed rings."""
    best = 1
    for s in range(1, R // 2 + 1):
        if s in (4, 6):
            continue
        if rails_for_all_to_all(s) <= rails:
            best = s
    return best


def split_dimensions(
    cfg: RailXConfig, specs: Sequence[DimensionSpec]
) -> Dict[str, DimensionSpec]:
    """Validate a dimension-splitting plan against the physical budget.

    Constraints (paper §3.3.4):
      * sum of rails of X (resp. Y) specs <= r
      * product of scales of specs sharing a physical dimension <= R/2
        (nodes along that side), since the split dimensions tile the
        physical node grid
      * all-to-all specs must satisfy Lemma 3.1's rail requirement.
    """
    cfg.validate()
    out: Dict[str, DimensionSpec] = {}
    for phys in ("X", "Y"):
        group = [s for s in specs if s.phys == phys]
        used = sum(s.rails for s in group)
        if used > cfg.r:
            raise ValueError(f"{phys}: rails used {used} > available r={cfg.r}")
        scale_prod = math.prod(s.scale for s in group) if group else 1
        if scale_prod > cfg.nodes_per_side:
            raise ValueError(
                f"{phys}: total split scale {scale_prod} > R/2={cfg.nodes_per_side}"
            )
        for s in group:
            if s.interconnect == "all_to_all":
                if s.scale in (4, 6):
                    raise ValueError(f"all-to-all scale {s.scale} impossible (k=4,6)")
                need = rails_for_all_to_all(s.scale)
                if need > s.rails:
                    raise ValueError(
                        f"dim {s.name}: a2a scale {s.scale} needs {need} rails,"
                        f" got {s.rails}"
                    )
            if s.name in out:
                raise ValueError(f"duplicate dimension name {s.name}")
            out[s.name] = s
    return out


# ---------------------------------------------------------------------------
# Logical topology construction (node-level graphs)
# ---------------------------------------------------------------------------


def ring_edges(order: Sequence[int]) -> List[Tuple[int, int]]:
    return [(order[i], order[(i + 1) % len(order)]) for i in range(len(order))]


def _add_edge(g: AdjGraph, a: Node, b: Node, mult: int = 1) -> None:
    g.setdefault(a, {})
    g.setdefault(b, {})
    g[a][b] = g[a].get(b, 0) + mult
    g[b][a] = g[b].get(a, 0) + mult


@lru_cache(maxsize=None)
def _rail_rings_cached(scale: int) -> Tuple[Tuple[int, ...], ...]:
    cycles = hamiltonian_decomposition(scale) if scale > 2 else [(0, 1)]
    return tuple(tuple(c) for c in cycles)


def all_to_all_rail_rings(scale: int) -> List[List[int]]:
    """The rail rings (node orders) wiring ``scale`` nodes all-to-all
    (Lemma 3.1).  Each returned ring is one rail's circuit configuration.

    The decomposition is memoized per scale (it is deterministic and the
    cluster scheduler requests the same handful of scales on every
    placement); callers get fresh lists so they may mutate freely."""
    return [list(c) for c in _rail_rings_cached(scale)]


def build_torus_2d(side: int) -> AdjGraph:
    """§3.3.1: 2D-Torus of side x side nodes (node coords (x, y))."""
    g: AdjGraph = {}
    for x in range(side):
        for y in range(side):
            _add_edge(g, (x, y), ((x + 1) % side, y))
            _add_edge(g, (x, y), (x, (y + 1) % side))
    return g


def build_hyperx_2d(scale: int, links_per_pair: int = 2) -> AdjGraph:
    """§3.3.2: (scale x scale) 2D-HyperX from rail-ring all-to-all per
    row/column.  Every node pair in a row (and column) is joined by
    ``links_per_pair`` direct links (paper: two, one per direction of the
    two distinct rails of Lemma 3.1)."""
    g: AdjGraph = {}
    for i in range(scale):
        for a in range(scale):
            for b in range(a + 1, scale):
                _add_edge(g, (i, a), (i, b), links_per_pair)   # row a2a (Y varies)
                _add_edge(g, (a, i), (b, i), links_per_pair)   # col a2a (X varies)
    return g


def build_dragonfly(group_size: int, num_groups: int) -> AdjGraph:
    """§3.3.3: groups of locally all-to-all nodes; groups all-to-all
    interconnected with one global link per group pair (node coords
    (group, member))."""
    g: AdjGraph = {}
    for gi in range(num_groups):
        for a in range(group_size):
            for b in range(a + 1, group_size):
                _add_edge(g, (gi, a), (gi, b), 2)
    # global links: group pair (g1, g2) connected via member chosen
    # round-robin so each node carries ~equal global links
    for g1 in range(num_groups):
        for g2 in range(g1 + 1, num_groups):
            a = (g1 + g2) % group_size
            b = (g1 * g2) % group_size
            _add_edge(g, (g1, a), (g2, b), 1)
    return g


def dragonfly_max_groups(cfg: RailXConfig) -> int:
    """§3.3.3: groups of r+1 nodes expose r(r+1) global rails; total group
    count min(r^2 + r + 1, R/2)."""
    return min(cfg.r ** 2 + cfg.r + 1, cfg.nodes_per_side)


def build_node_mesh(m: int) -> AdjGraph:
    """Intra-node m x m 2D-mesh of chips (not a torus: §3.2)."""
    g: AdjGraph = {}
    for x in range(m):
        for y in range(m):
            if x + 1 < m:
                _add_edge(g, (x, y), (x + 1, y))
            if y + 1 < m:
                _add_edge(g, (x, y), (x, y + 1))
    return g


# ---------------------------------------------------------------------------
# Topology metrics (Table 2)
# ---------------------------------------------------------------------------


def graph_diameter(g: AdjGraph) -> int:
    """BFS all-pairs diameter (node-level hops)."""
    import collections

    nodes = list(g)
    diam = 0
    for s in nodes:
        dist = {s: 0}
        dq = collections.deque([s])
        while dq:
            u = dq.popleft()
            for v in g[u]:
                if v not in dist:
                    dist[v] = dist[u] + 1
                    dq.append(v)
        if len(dist) != len(nodes):
            return -1  # disconnected
        diam = max(diam, max(dist.values()))
    return diam


def bisection_links(g: AdjGraph, axis: int = 0) -> int:
    """Links crossing the median cut along coordinate ``axis`` (counting
    multiplicity, both directions TX+RX as 2x)."""
    coords = sorted({nd[axis] for nd in g})
    half = coords[len(coords) // 2]
    lo = {nd for nd in g if nd[axis] < half}
    cross = 0
    for u in g:
        for v, mult in g[u].items():
            if (u in lo) != (v in lo):
                cross += mult
    return cross  # each undirected link counted twice = TX+RX


def table2_metrics(cfg: RailXConfig) -> Dict[str, Dict[str, float]]:
    """Closed-form Table 2 rows for this hardware config, assembled from
    the ``repro_torch.arch`` registry: every architecture declaring an
    ``analytical.table2`` entry contributes a row, ordered by the entry's
    declared position (seed rows: torus, hyperx, dragonfly)."""
    from ..arch import registry  # lazy: repro_torch.arch imports this module

    entries = sorted(
        (
            a.analytical.table2
            for a in registry.values()
            if a.analytical is not None and a.analytical.table2 is not None
        ),
        key=lambda e: e.order,
    )
    return {e.key: e.row(cfg) for e in entries}


# ---------------------------------------------------------------------------
# OCS wiring (physical circuit configuration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OCSPort:
    dim: Literal["X", "Y"]
    group: int   # which node row (Y) / column (X) this OCS group serves
    rail: int    # rail id within the group (0..r-1)
    port: int    # port index on the switch (0..R-1)


@dataclasses.dataclass
class CircuitConfig:
    """A full OCS configuration: for each switch, the set of port pairs
    (circuits).  Produced by ``configure_rails``; consumed by tests and the
    availability/MLaaS allocators."""

    circuits: Dict[Tuple[str, int, int], List[Tuple[int, int]]]
    # key = (dim, group, rail) identifying one OCS; value = list of port pairs

    def circuit_count(self) -> int:
        return sum(len(v) for v in self.circuits.values())


def configure_rails(
    cfg: RailXConfig,
    ring_orders: Dict[Tuple[str, int, int], Sequence[int]],
) -> CircuitConfig:
    """Configure each OCS to realize per-rail node rings.

    ``ring_orders[(dim, group, rail)]`` is the node order of the ring that
    rail should realize along its row/column.  Node j's +port is 2j and
    -port is 2j+1 on its OCS (a node row/column holds <= R/2 nodes so ports
    fit the radix R).  A circuit connects the +port of each node to the
    -port of its ring successor.
    """
    circuits: Dict[Tuple[str, int, int], List[Tuple[int, int]]] = {}
    for key, order in ring_orders.items():
        pairs = []
        L = len(order)
        for idx in range(L):
            a, b = order[idx], order[(idx + 1) % L]
            pairs.append((2 * a, 2 * b + 1))  # a's +port -> b's -port
        circuits[key] = pairs
    return CircuitConfig(circuits=circuits)


def hyperx_ring_orders(cfg: RailXConfig, scale: int) -> Dict[Tuple[str, int, int], List[int]]:
    """Ring orders configuring every row and column as rail-ring all-to-all
    of ``scale`` nodes (§3.3.2, Figure 7)."""
    rails = all_to_all_rail_rings(scale)
    if len(rails) > cfg.r:
        raise ValueError(
            f"a2a scale {scale} needs {len(rails)} rails > r={cfg.r}"
        )
    orders: Dict[Tuple[str, int, int], List[int]] = {}
    for dim in ("X", "Y"):
        for group in range(scale):
            for rid, ring in enumerate(rails):
                orders[(dim, group, rid)] = list(ring)
    return orders


def torus_ring_orders(cfg: RailXConfig, side: int) -> Dict[Tuple[str, int, int], List[int]]:
    """Every rail configured as the identity ring 0->1->...->side-1 (§3.3.1)."""
    orders: Dict[Tuple[str, int, int], List[int]] = {}
    for dim in ("X", "Y"):
        for group in range(side):
            for rid in range(cfg.r):
                orders[(dim, group, rid)] = list(range(side))
    return orders
