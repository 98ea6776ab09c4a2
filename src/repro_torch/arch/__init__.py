"""``repro_torch.arch`` — the network-architecture registry (the port's own
copy of ``repro.arch``, with every capability of the reference's).

Every fabric this repo can reason about is described **once**, by a
single :class:`~repro_torch.arch.registry.Architecture` registration carrying
all of its capabilities: the chip-granularity flow network
(``build_flow`` / the normalized ``flow_fig14``), the canonical CSR
builder with its translation-symmetry group (``build_compiled``),
closed-form analytics (Eqs. 2-4 all-to-all, Fig. 15 All-Reduce, Table 2
row), the Table 6 cost model (``cost`` / ``cost_variants``), next-hop
routing, and OCS ``ring_orders`` circuit synthesis.  Capabilities are
optional; callers introspect with ``arch.has(cap)`` / ``arch.capabilities()`` and degrade gracefully
(e.g. run the exact O(N²) sweep when no symmetry group exists, or skip a
fabric in a sweep it declares nothing for).

The registry-driven consumers — ``core.cost.table6`` /
``core.topology.table2_metrics`` / ``core.analytical.paper_fig15_curves``
and ``chip_smoke.py``'s Fig. 14 points — iterate this registry, so
**registering a new fabric is the whole job** of adding it to every sweep.

Worked example — the Rail-only registration (Wang et al., 2023,
arXiv:2307.12169), registered in :mod:`repro_torch.arch.fabrics`::

    def build_rail_only_flow(num_domains, d, k_internal, rail_cap=1.0):
        net = FlowNetwork()
        for D in range(num_domains):          # HB domain scale-up fabric
            for j in range(d):
                net.add_link(("gpu", D, j), ("dom", D), k_internal * rail_cap)
        for D in range(num_domains):          # rail plane j joins rank j
            for j in range(d):
                net.add_link(("gpu", D, j), ("rail", j), rail_cap)
        chips = [("gpu", D, j) for D in range(num_domains) for j in range(d)]
        return FlowBuild(net=net, chips=chips)

    register(Architecture(
        name="rail-only",
        description="Rail-only: NVLink HB domains + per-rank rail planes",
        paper="arXiv:2307.12169",
        build_flow=build_rail_only_flow,
        # normalized Fig. 14 shape: scale²·m² chips; declaring a
        # fig14_label adds the fabric's curve to every Fig. 14 sweep
        flow_fig14=lambda scale, m, k, inj: build_rail_only_flow(
            scale * scale, m * m, k, 4.0 * (scale - 1) / (m * m)),
        fig14_label="rail_only",
        fig14_order=40,
        # one CostVariant per Table 6 row; ``order`` fixes the row slot
        cost=lambda prices=Prices(), chips=4096:
            rail_only_rail_planes(chips, prices),
        cost_variants=(CostVariant(
            order=130, build=lambda p: rail_only_rail_planes(4096, p)),),
    ))

No ``build_compiled`` / ``analytical`` / ``routing`` capability is
declared, so symmetry-mode sweeps, Table 2 and routing tests simply skip
it — nothing else to update.  Registering the fabric makes the
``fig14a_rail_only`` curve and the Table 6 "Rail-Only (rail planes)" row
appear in the benchmark harness for free.
"""

from . import fabrics  # noqa: F401  (populates the registry on import)
from .registry import (  # noqa: F401
    AnalyticalForms,
    Architecture,
    ArchitectureRegistry,
    CostVariant,
    FlowBuild,
    RoutingSupport,
    Table2Entry,
    fig14_archs,
    get,
    names,
    register,
    registry,
)

__all__ = [
    "AnalyticalForms",
    "Architecture",
    "ArchitectureRegistry",
    "CostVariant",
    "FlowBuild",
    "RoutingSupport",
    "Table2Entry",
    "fabrics",
    "fig14_archs",
    "get",
    "names",
    "register",
    "registry",
]
