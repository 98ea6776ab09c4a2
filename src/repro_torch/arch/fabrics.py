"""Built-in architecture registrations (the Table 2/6 + Fig. 14 fabrics).

The port's own copy of ``repro/arch/fabrics.py``: the same ten
registrations with every capability, ``job_network`` on ``railx-hyperx``,
``torus-2d``, ``torus-3d`` and ``rail-only`` (its builders live in
``cluster.metrics``, imported lazily: ``cluster`` imports this package).
``build_compiled`` / ``compiled_fig14`` build the port's ``CompiledNetwork``
(tensors on ``device``, the card by default).

The flow builders that used to live in ``core.simulator`` are the
canonical implementations here; ``core.simulator.build_*`` remain as thin
deprecated aliases resolving through the registry.  Construction code is
kept verbatim — ``FlowNetwork`` adjacency insertion order determines BFS
tie-breaking, so moving a builder must not reorder a single ``add_link``.
"""

from __future__ import annotations

import itertools
from typing import List

from ..core import analytical as ana
from ..core import cost as cost_mod
from ..core import routing as routing_mod
from ..core import topology as topo
from ..core.compiled_flow import (
    build_compiled_fattree,
    build_compiled_railx_hyperx,
    build_compiled_torus2d,
)
from ..core.simulator import FlowNetwork
from .registry import (
    AnalyticalForms,
    Architecture,
    CostVariant,
    FlowBuild,
    RoutingSupport,
    Table2Entry,
    register,
)


def _grid_chips(scale: int, m: int) -> List:
    return [
        (X, Y, x, y)
        for X in range(scale)
        for Y in range(scale)
        for x in range(m)
        for y in range(m)
    ]


# ---------------------------------------------------------------------------
# Flow builders (chip granularity) — canonical homes of the seed builders
# ---------------------------------------------------------------------------


def build_railx_hyperx_flow(
    scale: int, m: int, k_internal: float, links_per_pair: int = 2
) -> FlowBuild:
    """(scale x scale) RailX-HyperX at chip granularity.

    Vertices: (X, Y, x, y).  Intra-node mesh links capacity ``k_internal``;
    each ordered row/column node pair has ``links_per_pair`` unit links,
    endpoint chips assigned round-robin along the mesh edge (rails live on
    distinct chip rows/columns — §3.2)."""
    net = FlowNetwork()
    for X in range(scale):
        for Y in range(scale):
            for x in range(m):
                for y in range(m):
                    if x + 1 < m:
                        net.add_link((X, Y, x, y), (X, Y, x + 1, y), k_internal)
                    if y + 1 < m:
                        net.add_link((X, Y, x, y), (X, Y, x, y + 1), k_internal)
    for Y in range(scale):
        for a, b in itertools.combinations(range(scale), 2):
            for l in range(links_per_pair):
                row = (a + b + l) % m
                net.add_link((a, Y, row, 0), (b, Y, row, 0), 1.0)
    for X in range(scale):
        for a, b in itertools.combinations(range(scale), 2):
            for l in range(links_per_pair):
                col = (a + b + l) % m
                net.add_link((X, a, 0, col), (X, b, 0, col), 1.0)
    return FlowBuild(net=net, chips=_grid_chips(scale, m))


def build_torus2d_flow(side: int, m: int, k_internal: float) -> FlowBuild:
    """side x side node 2D-Torus of m x m mesh nodes (Fig. 14 baseline)."""
    net = FlowNetwork()
    for X in range(side):
        for Y in range(side):
            for x in range(m):
                for y in range(m):
                    if x + 1 < m:
                        net.add_link((X, Y, x, y), (X, Y, x + 1, y), k_internal)
                    if y + 1 < m:
                        net.add_link((X, Y, x, y), (X, Y, x, y + 1), k_internal)
    for X in range(side):
        for Y in range(side):
            for l in range(m):  # one rail per chip row/col = m parallel links
                net.add_link((X, Y, l, m - 1), ((X + 1) % side, Y, l, 0), 1.0)
                net.add_link((X, Y, m - 1, l), (X, (Y + 1) % side, 0, l), 1.0)
    return FlowBuild(net=net, chips=_grid_chips(side, m))


def build_fattree_flow(
    chips: int, ports: float = 1.0, taper: float = 1.0
) -> FlowBuild:
    """Idealized non-blocking (or tapered) fat-tree: star through a core
    vertex with per-chip uplink capacity ports/taper (throughput-equivalent
    abstraction for flow-level analysis)."""
    net = FlowNetwork()
    for c in range(chips):
        net.add_link(("chip", c), "core", ports / taper)
    return FlowBuild(net=net, chips=[("chip", c) for c in range(chips)])


def build_rail_only_flow(
    num_domains: int,
    d: int,
    k_internal: float,
    rail_cap: float = 1.0,
) -> FlowBuild:
    """Rail-only (Wang et al., 2023): HB domains + per-rank rail planes.

    ``num_domains`` HB domains of ``d`` chips each.  The scale-up domain
    fabric (NVSwitch-class, full bandwidth any-to-any) is modeled as a
    star through a domain hub with per-chip capacity ``k_internal *
    rail_cap``; rail plane ``j`` is a star joining chip ``j`` of every
    domain with per-chip capacity ``rail_cap``.  There is no any-to-any
    datacenter core — cross-rank traffic must first move inside a domain,
    the architecture's defining bet."""
    net = FlowNetwork()
    for D in range(num_domains):
        for j in range(d):
            net.add_link(("gpu", D, j), ("dom", D), k_internal * rail_cap)
    for D in range(num_domains):
        for j in range(d):
            net.add_link(("gpu", D, j), ("rail", j), rail_cap)
    chips = [("gpu", D, j) for D in range(num_domains) for j in range(d)]
    return FlowBuild(net=net, chips=chips)


def build_ub_mesh_2level_flow(
    scale: int, m: int, k_internal: float, pair_cap: float = 1.0
) -> FlowBuild:
    """UB-Mesh-style 2-level full mesh (Liao et al., 2025 nD-FullMesh).

    Level 1: the ``m² `` chips of each node are fully meshed at capacity
    ``k_internal`` per pair (hierarchical locality: board traces).
    Level 2: the ``scale²`` nodes are fully meshed, every node pair one
    direct link of capacity ``pair_cap`` landing on chip ``(a + b) % m²``
    of both endpoints (round-robin, like the RailX rail assignment)."""
    m2 = m * m
    net = FlowNetwork()
    for X in range(scale):
        for Y in range(scale):
            for a, b in itertools.combinations(range(m2), 2):
                net.add_link(
                    (X, Y, a // m, a % m), (X, Y, b // m, b % m), k_internal
                )
    nodes = [(X, Y) for X in range(scale) for Y in range(scale)]
    for i, na in enumerate(nodes):
        for j in range(i + 1, len(nodes)):
            nb = nodes[j]
            c = (i + j) % m2
            net.add_link(
                (na[0], na[1], c // m, c % m),
                (nb[0], nb[1], c // m, c % m),
                pair_cap,
            )
    return FlowBuild(net=net, chips=_grid_chips(scale, m))


# ---------------------------------------------------------------------------
# Fig. 14 normalized entry points (scale² · m² chips each)
# ---------------------------------------------------------------------------


def _railx_fig14(scale: int, m: int, k_internal: float, inj: float) -> FlowBuild:
    return build_railx_hyperx_flow(scale, m, k_internal)


def _torus2d_fig14(scale: int, m: int, k_internal: float, inj: float) -> FlowBuild:
    return build_torus2d_flow(scale, m, k_internal)


def _fattree_fig14(scale: int, m: int, k_internal: float, inj: float) -> FlowBuild:
    return build_fattree_flow(scale * scale * m * m, ports=inj)


def _rail_only_fig14(scale: int, m: int, k_internal: float, inj: float) -> FlowBuild:
    # Same aggregate inter-node bandwidth per node as the Fig. 14 RailX
    # grid (4(scale-1) unit links), spread over the node's m² rail ports.
    rail_cap = 4.0 * (scale - 1) / (m * m)
    return build_rail_only_flow(scale * scale, m * m, k_internal, rail_cap)


def _ub_mesh_fig14(scale: int, m: int, k_internal: float, inj: float) -> FlowBuild:
    # Same aggregate inter-node bandwidth per node as the Fig. 14 RailX
    # grid, spread evenly over the scale² - 1 full-mesh peers.
    pair_cap = 4.0 * (scale - 1) / (scale * scale - 1)
    return build_ub_mesh_2level_flow(scale, m, k_internal, pair_cap)


# ---------------------------------------------------------------------------
# Analytical closed forms (Table 2 rows + Fig. 15 All-Reduce curves)
# ---------------------------------------------------------------------------


def _table2_torus(cfg: topo.RailXConfig):
    r, R, m, n = cfg.r, cfg.R, cfg.m, cfg.n
    return {
        "scale": (R / 2) ** 2 * m ** 2,
        "diameter_ho": R,
        "bisection_per_chip": 16 * n / (R * m),
    }


def _table2_hyperx(cfg: topo.RailXConfig):
    r, R, m, n = cfg.r, cfg.R, cfg.m, cfg.n
    return {
        "scale": (r + 1) ** 2 * m ** 2,
        "diameter_ho": 2,
        "bisection_per_chip": 2 * n / m,
    }


def _table2_dragonfly(cfg: topo.RailXConfig):
    r, R, m, n = cfg.r, cfg.R, cfg.m, cfg.n
    return {
        "scale": (r + 1) * (R / 2) * m ** 2,
        "diameter_ho": 3,
        "bisection_per_chip": 2 * n / m,
    }


def _railx_allreduce_time(m, p, V, nB, alpha, k=4.0, alpha_int=0.0):
    """Fig. 15 'hierarchical' curve (paper Eq. 8)."""
    return ana.t_allreduce_hierarchical(m, p, V, nB, alpha, k, alpha_int)


def _torus2d_allreduce_time(m, p, V, nB, alpha, k=4.0, alpha_int=0.0):
    """Fig. 15 '2D-ring' curve (paper Eq. 7); k/alpha_int unused."""
    return ana.t_allreduce_2d_ring(m, p, V, nB, alpha)


def _railx_job_network(cfg, mapping, alloc) -> FlowNetwork:
    from ..cluster.metrics import build_job_network

    return build_job_network(cfg, mapping, alloc)


def _torus2d_job_network(cfg, mapping, alloc) -> FlowNetwork:
    from ..cluster.metrics import build_job_network_torus

    return build_job_network_torus(cfg, mapping, alloc)


def _rail_only_job_network(cfg, mapping, alloc) -> FlowNetwork:
    from ..cluster.metrics import build_job_network_rail_only

    return build_job_network_rail_only(cfg, mapping, alloc)


def _torus3d_job_network(cfg, mapping, alloc) -> FlowNetwork:
    from ..cluster.metrics import build_job_network_torus3d

    return build_job_network_torus3d(cfg, mapping, alloc)


# ---------------------------------------------------------------------------
# Registrations
# ---------------------------------------------------------------------------


RAILX_HYPERX = register(Architecture(
    name="railx-hyperx",
    description="RailX 2D-HyperX: OCS rail-rings configure every node "
    "row/column all-to-all (paper §3.3.2)",
    paper="RailX (this repo's source paper)",
    build_flow=build_railx_hyperx_flow,
    flow_fig14=_railx_fig14,
    fig14_label="railx_hyperx",
    fig14_order=10,
    build_compiled=build_compiled_railx_hyperx,
    compiled_fig14=build_compiled_railx_hyperx,
    analytical=AnalyticalForms(
        alltoall_per_chip=lambda cfg: ana.alltoall_throughput_hyperx(
            cfg.m, cfg.n
        ),
        allreduce_time=_railx_allreduce_time,
        table2=Table2Entry(key="hyperx", order=20, row=_table2_hyperx),
    ),
    cost=lambda prices=cost_mod.Prices(), m=4, n=9, R=128: cost_mod.railx(
        m, n, R, prices
    ),
    cost_variants=(
        CostVariant(order=80, build=lambda p: cost_mod.railx(4, prices=p)),
        CostVariant(order=90, build=lambda p: cost_mod.railx(7, prices=p)),
    ),
    routing=RoutingSupport(
        topology="hyperx",
        minimal=routing_mod.minimal_route,
        nonminimal=routing_mod.nonminimal_route,
    ),
    ring_orders=topo.hyperx_ring_orders,
    build_adj=topo.build_hyperx_2d,
    job_network=_railx_job_network,
))


TORUS_2D = register(Architecture(
    name="torus-2d",
    description="2D-Torus: every OCS rail the identity ring (paper §3.3.1)",
    build_flow=build_torus2d_flow,
    flow_fig14=_torus2d_fig14,
    fig14_label="torus2d",
    fig14_order=20,
    build_compiled=build_compiled_torus2d,
    compiled_fig14=build_compiled_torus2d,
    analytical=AnalyticalForms(
        alltoall_per_chip=lambda cfg: ana.alltoall_throughput_torus(
            cfg.R, cfg.m, cfg.n
        ),
        allreduce_time=_torus2d_allreduce_time,
        table2=Table2Entry(key="torus", order=10, row=_table2_torus),
    ),
    routing=RoutingSupport(
        topology="torus",
        minimal=routing_mod.minimal_route,
        nonminimal=routing_mod.nonminimal_route,
    ),
    ring_orders=topo.torus_ring_orders,
    build_adj=topo.build_torus_2d,
    job_network=_torus2d_job_network,
))


TORUS_3D = register(Architecture(
    name="torus-3d",
    description="3D-Torus of 4³-chip cubes (TPUv4-class, with/without OCS)",
    cost=lambda prices=cost_mod.Prices(), chips=4096, with_ocs=True:
        cost_mod.torus_3d(with_ocs, cubes=chips // 64, prices=prices),
    cost_variants=(
        CostVariant(order=50, build=lambda p: cost_mod.torus_3d(True, prices=p)),
        CostVariant(order=60, build=lambda p: cost_mod.torus_3d(False, prices=p)),
    ),
    job_network=_torus3d_job_network,
))


FAT_TREE_NONBLOCKING = register(Architecture(
    name="fat-tree-nonblocking",
    description="Non-blocking folded-Clos fat-tree (full bisection)",
    build_flow=build_fattree_flow,
    flow_fig14=_fattree_fig14,
    fig14_label="fattree",
    fig14_order=30,
    build_compiled=build_compiled_fattree,
    cost=lambda prices=cost_mod.Prices(), chips=2048, tiers=2:
        cost_mod.fat_tree(
            f"{tiers}-Tier Nonbl. FT", chips, [1.0] * (tiers - 1), prices
        ),
    cost_variants=(
        CostVariant(order=10, build=cost_mod.fat_tree_2tier_nonblocking),
        CostVariant(order=100, build=cost_mod.fat_tree_4tier_nonblocking),
    ),
))


FAT_TREE_TAPERED = register(Architecture(
    name="fat-tree-tapered",
    description="Tapered folded-Clos fat-tree (oversubscribed upper tiers)",
    build_flow=lambda chips, ports=1.0, taper=3.0: build_fattree_flow(
        chips, ports, taper
    ),
    cost=lambda prices=cost_mod.Prices(), chips=3072, tapers=(3.0,):
        cost_mod.fat_tree("1:3 Tap. 2-Tier FT", chips, list(tapers), prices),
    cost_variants=(
        CostVariant(order=20, build=cost_mod.fat_tree_2tier_tapered),
        CostVariant(order=110, build=cost_mod.fat_tree_3tier_tapered),
    ),
))


DRAGONFLY = register(Architecture(
    name="dragonfly",
    description="Dragonfly: locally all-to-all groups, one global link per "
    "group pair (paper §3.3.3)",
    analytical=AnalyticalForms(
        alltoall_per_chip=lambda cfg: ana.alltoall_throughput_dragonfly(
            cfg.m, cfg.n
        ),
        table2=Table2Entry(key="dragonfly", order=30, row=_table2_dragonfly),
    ),
    build_adj=topo.build_dragonfly,
))


HAMMINGMESH = register(Architecture(
    name="hammingmesh",
    description="HammingMesh: a x a chip boards with per-row/column rail "
    "fat-trees (HxaMesh)",
    cost=lambda prices=cost_mod.Prices(), a=4, boards=1024, ft_tiers=1:
        cost_mod.hammingmesh(a, boards, ft_tiers, prices),
    cost_variants=(
        CostVariant(order=30, build=lambda p: cost_mod.hammingmesh(4, 1024, 1, p)),
        CostVariant(order=40, build=lambda p: cost_mod.hammingmesh(7, 1024, 1, p)),
        CostVariant(order=120, build=lambda p: cost_mod.hammingmesh(7, 4096, 2, p)),
    ),
))


RAIL_ONLY_2D_FT = register(Architecture(
    name="rail-only-2d-ft",
    description="Rail-Only priced as two 1-tier fat-tree planes (the "
    "paper's Table 6 comparison row)",
    cost=lambda prices=cost_mod.Prices(), chips=4096:
        cost_mod.rail_only_2d_ft(chips, prices),
    cost_variants=(
        CostVariant(order=70, build=lambda p: cost_mod.rail_only_2d_ft(4096, p)),
    ),
))


RAIL_ONLY = register(Architecture(
    name="rail-only",
    description="Rail-only (Wang et al., 2023): NVLink HB domains + "
    "per-rank rail planes, no any-to-any core",
    paper="arXiv:2307.12169",
    build_flow=build_rail_only_flow,
    flow_fig14=_rail_only_fig14,
    fig14_label="rail_only",
    fig14_order=40,
    cost=lambda prices=cost_mod.Prices(), chips=4096:
        cost_mod.rail_only_rail_planes(chips, prices),
    cost_variants=(
        CostVariant(
            order=130, build=lambda p: cost_mod.rail_only_rail_planes(4096, p)
        ),
    ),
    job_network=_rail_only_job_network,
))


UB_MESH_2LEVEL = register(Architecture(
    name="ub-mesh-2level",
    description="UB-Mesh-style 2-level full mesh: chips fully meshed "
    "within a node, nodes fully meshed with direct links",
    paper="arXiv:2503.20377",
    build_flow=build_ub_mesh_2level_flow,
    flow_fig14=_ub_mesh_fig14,
    fig14_label="ub_mesh_2level",
    fig14_order=50,
    cost=lambda prices=cost_mod.Prices(), nodes=64, d=64:
        cost_mod.ub_mesh_2level(nodes, d, prices),
    cost_variants=(
        CostVariant(
            order=140, build=lambda p: cost_mod.ub_mesh_2level(64, 64, p)
        ),
    ),
))
