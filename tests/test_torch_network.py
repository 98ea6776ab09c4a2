"""The port's network core (``repro_torch.core``: hamiltonian, topology,
routing, analytical, cost, mapping; ``repro_torch.arch``: the registry and
its ten fabrics) against the reference's, at equality: the same cycles,
tables, routes, plans and registrations, every capability included
(``job_network``'s goodput is held in ``tests/test_torch_cluster.py``)."""

import dataclasses
import itertools
import random

import pytest

torch = pytest.importorskip("torch")

from repro import arch as ref_arch  # noqa: E402
from repro.core import (  # noqa: E402
    analytical as ref_ana, cost as ref_cost, hamiltonian as ref_ham, mapping as ref_map,
    routing as ref_routing, topology as ref_topo,
)
from repro_torch import arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    analytical, cost, hamiltonian, mapping, routing, topology,
)
from repro_torch.launch.mesh import railx_mesh_from_plan  # noqa: E402

def plain(x):
    """Dataclasses of either package as dicts, sequences as lists, so that
    the two packages' values compare with ``==`` (floats bit for bit)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def same(got, want):
    assert plain(got) == plain(want)


def agree(fn, ref_fn, *args):
    """``fn(*args)`` and ``ref_fn(*args)`` return equal values or raise the
    same error."""
    try:
        want = ref_fn(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            fn(*args)
        assert str(err.value) == str(e)
        return
    same(fn(*args), want)


# -- hamiltonian -------------------------------------------------------------


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
@pytest.mark.parametrize("k", range(3, 14))
def test_hamiltonian_decomposition_matches_the_reference(k, directed):
    """Walecki (odd k) and Tillson (even k, the seeded search) give the same
    cycles; k = 4 and 6 raise the same error; each decomposition verifies."""
    if k in (4, 6):
        with pytest.raises(ValueError) as want:
            ref_ham.hamiltonian_decomposition(k, directed=directed)
        with pytest.raises(ValueError) as got:
            hamiltonian.hamiltonian_decomposition(k, directed=directed)
        assert str(got.value) == str(want.value)
        return
    cycles = hamiltonian.hamiltonian_decomposition(k, directed=directed)
    assert cycles == ref_ham.hamiltonian_decomposition(k, directed=directed)
    # even k always decomposes the directed K*_k, as the reference documents
    hamiltonian.verify_decomposition(k, cycles, directed or k % 2 == 0)
    assert hamiltonian.rails_for_all_to_all(k) == ref_ham.rails_for_all_to_all(k)
    for a, b in itertools.permutations(range(k), 2):
        assert hamiltonian.direct_rails_between(k, a, b) == ref_ham.direct_rails_between(k, a, b)


def test_verify_decomposition_rejects_as_the_reference():
    bad = hamiltonian.hamiltonian_decomposition(7)[:-1]
    for mod in (hamiltonian, ref_ham):
        with pytest.raises(AssertionError):
            mod.verify_decomposition(7, bad, False)


# -- topology ----------------------------------------------------------------

CONFIGS = [(4, 9, 128), (2, 2, 16), (7, 9, 128), (4, 4, 64)]


@pytest.mark.parametrize("m,n,R", CONFIGS)
def test_config_table2_and_ring_orders_match_the_reference(m, n, R):
    cfg, rcfg = topology.RailXConfig(m=m, n=n, R=R), ref_topo.RailXConfig(m=m, n=n, R=R)
    for attr in ("r", "nodes_per_side", "num_nodes", "chips_per_node", "num_chips",
                 "num_switches"):
        assert getattr(cfg, attr) == getattr(rcfg, attr), attr
    assert topology.table2_metrics(cfg) == ref_topo.table2_metrics(rcfg)
    assert topology.tpuv4_max_chips(R, m) == ref_topo.tpuv4_max_chips(R, m)
    assert topology.dragonfly_max_groups(cfg) == ref_topo.dragonfly_max_groups(rcfg)
    for scale in (3, 5, 8):
        agree(lambda s: topology.hyperx_ring_orders(cfg, s),
              lambda s: ref_topo.hyperx_ring_orders(rcfg, s), scale)
        if scale < cfg.r:
            orders = topology.hyperx_ring_orders(cfg, scale)
            same(topology.configure_rails(cfg, orders), ref_topo.configure_rails(rcfg, orders))
        orders = topology.torus_ring_orders(cfg, scale)
        assert orders == ref_topo.torus_ring_orders(rcfg, scale)
        same(topology.configure_rails(cfg, orders), ref_topo.configure_rails(rcfg, orders))


@pytest.mark.parametrize("scale", range(2, 12))
def test_rail_rings_and_graphs_match_the_reference(scale):
    agree(topology.all_to_all_rail_rings, ref_topo.all_to_all_rail_rings, scale)
    assert topology.min_scale_bound_a2a(scale, 128) == ref_topo.min_scale_bound_a2a(scale, 128)
    for build, args in ((topology.build_torus_2d, (scale,)),
                        (topology.build_hyperx_2d, (scale,)),
                        (topology.build_hyperx_2d, (scale, 1)),
                        (topology.build_dragonfly, (scale, scale + 1)),
                        (topology.build_node_mesh, (scale,))):
        g, want = build(*args), getattr(ref_topo, build.__name__)(*args)
        assert g == want and list(g) == list(want)
        assert topology.graph_diameter(g) == ref_topo.graph_diameter(want)
        assert topology.bisection_links(g) == ref_topo.bisection_links(want)


SPLITS = [  # (name, scale, rails, interconnect, phys) per spec; the last three raise
    [("ep", 8, 4, "all_to_all", "X"), ("dp", 8, 10, "ring", "X"), ("tp", 16, 18, "ring", "Y")],
    [("cp", 9, 4, "all_to_all", "Y"), ("pp", 4, 2, "ring", "Y"), ("dp", 64, 30, "ring", "X")],
    [("ep", 4, 8, "all_to_all", "X")],
    [("dp", 8, 40, "ring", "X")],
    [("dp", 8, 2, "ring", "X"), ("dp", 8, 2, "ring", "Y")],
]


@pytest.mark.parametrize("specs", SPLITS)
def test_split_dimensions_matches_the_reference(specs):
    cfg, rcfg = topology.RailXConfig(m=4, n=9, R=128), ref_topo.RailXConfig(m=4, n=9, R=128)
    got = [topology.DimensionSpec(*s) for s in specs]
    want = [ref_topo.DimensionSpec(*s) for s in specs]
    for g, w in zip(got, want):
        assert (g.max_scale(128), g.bandwidth_ports()) == (w.max_scale(128), w.bandwidth_ports())
    agree(lambda specs: topology.split_dimensions(cfg, got),
          lambda specs: ref_topo.split_dimensions(rcfg, want), specs)


# -- routing -----------------------------------------------------------------


@pytest.mark.parametrize("m,scale,topo", [(2, 3, "hyperx"), (4, 5, "hyperx"), (4, 9, "hyperx"),
                                          (2, 8, "torus"), (3, 5, "torus")])
def test_routes_and_hop_counts_match_the_reference(m, scale, topo):
    p = routing.RoutingParams(m=m, scale_x=scale, scale_y=scale, topology=topo)
    rp = ref_routing.RoutingParams(m=m, scale_x=scale, scale_y=scale, topology=topo)
    rng = random.Random(0)
    for _ in range(60):
        src, dst = ((rng.randrange(scale), rng.randrange(scale), rng.randrange(m),
                     rng.randrange(m)) for _ in range(2))
        hops = routing.minimal_route(p, src, dst)
        same(hops, ref_routing.minimal_route(rp, src, dst))
        assert routing.count_hops(hops) == ref_routing.count_hops(hops)
        assert routing.max_vc(hops) == ref_routing.max_vc(hops)
        assert routing.route_length_cycles(hops) == ref_routing.route_length_cycles(hops)
        routing.verify_deadlock_discipline(hops)
        via = [(rng.randrange(scale), rng.randrange(scale))]
        same(routing.nonminimal_route(p, src, dst, via),
             ref_routing.nonminimal_route(rp, src, dst, via))
    assert routing.hyperx_diameter_bound(m) == ref_routing.hyperx_diameter_bound(m)
    same(routing.mesh_route(1, 2, (0, 0), (m - 1, m - 1), 3),
         ref_routing.mesh_route(1, 2, (0, 0), (m - 1, m - 1), 3))


# -- analytical and cost -----------------------------------------------------


def test_analytical_forms_match_the_reference():
    for R, m, n in ((128, 4, 9), (64, 2, 2), (32, 7, 4)):
        for fn in ("alltoall_throughput_hyperx", "alltoall_throughput_dragonfly"):
            assert getattr(analytical, fn)(m, n) == getattr(ref_ana, fn)(m, n)
        assert analytical.alltoall_throughput_torus(R, m, n) == \
            ref_ana.alltoall_throughput_torus(R, m, n)
    for p, V, B, a in ((4, 1e6, 100e9, 1e-6), (16, 3e8, 9e11, 3e-7), (64, 1.5e9, 2e11, 0.0)):
        for fn in ("t_ring_phase", "t_allreduce_ring", "t_ar_a2a_phase"):
            assert getattr(analytical, fn)(p, V, B, a) == getattr(ref_ana, fn)(p, V, B, a)
        for m in (2, 4):
            assert analytical.t_allreduce_2d_ring(m, p, V, B, a) == \
                ref_ana.t_allreduce_2d_ring(m, p, V, B, a)
            assert analytical.t_allreduce_hierarchical(m, p, V, B, a, 4.0, 1e-8) == \
                ref_ana.t_allreduce_hierarchical(m, p, V, B, a, 4.0, 1e-8)


def test_fig15_curves_match_the_reference():
    sizes = [2.0 ** e for e in range(10, 31, 4)]
    for m, n, scales in ((2, 2, (4, 8, 16, 32)), (4, 9, (8, 16))):
        got = analytical.paper_fig15_curves(sizes, scales, m=m, n=n)
        assert got == ref_ana.paper_fig15_curves(sizes, scales, m=m, n=n)


def test_tables_3_and_6_match_the_reference():
    same(cost.table6(), ref_cost.table6())
    assert list(cost.table6()) == list(ref_cost.table6())
    assert cost.table3() == ref_cost.table3()
    same(cost.table6(cost.Prices(pcc=300.0, aot=900.0)),
         ref_cost.table6(ref_cost.Prices(pcc=300.0, aot=900.0)))
    for m in (2, 4, 7):
        same(cost.railx(m), ref_cost.railx(m))


# -- mapping -----------------------------------------------------------------

# examples/quickstart.py step 2's workload, and tests/test_mapping.py's
QUICKSTART = (dict(layers=80, hidden=8192, intermediate=28672, vocab=128256, heads=64,
                   kv_heads=8, experts=8, top_k=2),
              dict(tp=16, cp=2, ep=8, dp=16, pp=4),
              dict(micro_batch=1, num_micro_batches=8, seq_len=8192))
LLAMA70B = (QUICKSTART[0], dict(tp=4, cp=2, ep=2, dp=4, pp=2), QUICKSTART[2])


def _workload(mod, model, plan, shape):
    return mod.ModelSpec(**model), mod.ParallelismPlan(**plan), mod.WorkloadShape(**shape)


@pytest.mark.parametrize("work", [QUICKSTART, LLAMA70B], ids=["quickstart", "llama70b"])
def test_mapping_matches_the_reference(work):
    cfg, rcfg = topology.RailXConfig(m=4, n=9, R=128), ref_topo.RailXConfig(m=4, n=9, R=128)
    got = _workload(mapping, *work)
    want = _workload(ref_map, *work)
    same(mapping.table4_volumes(*got), ref_map.table4_volumes(*want))
    res = mapping.plan_dimension_split(cfg, *got)
    ref_res = ref_map.plan_dimension_split(rcfg, *want)
    same(res, ref_res)
    assert isinstance(res, mapping.MappingResult)
    for v1, v2, ports, bw in ((1e9, 1e9, 10, 50e9), (1e9, 4e9, 10, 50e9), (3e8, 2e9, 36, 1e11)):
        assert mapping.allocate_bandwidth_static(v1, v2, ports, bw) == \
            ref_map.allocate_bandwidth_static(v1, v2, ports, bw)
        assert mapping.allocate_bandwidth_dynamic(v1, v2, ports, bw, switch_gap=6e-3) == \
            ref_map.allocate_bandwidth_dynamic(v1, v2, ports, bw, switch_gap=6e-3)


def test_railx_mesh_from_plan_takes_the_ports_mapping_result():
    """``launch/mesh.railx_mesh_from_plan`` reads the port's own
    ``MappingResult``: the mesh of the quickstart's split, its scales > 1 in
    spec order, as from the reference's."""
    cfg = topology.RailXConfig(m=4, n=9, R=128)
    res = mapping.plan_dimension_split(cfg, *_workload(mapping, *QUICKSTART))
    sizes, names = railx_mesh_from_plan(res)
    assert (sizes, names) == railx_mesh_from_plan(
        ref_map.plan_dimension_split(ref_topo.RailXConfig(m=4, n=9, R=128),
                                     *_workload(ref_map, *QUICKSTART)))
    assert list(zip(sizes, names)) == [(s.scale, s.name) for s in res.specs if s.scale > 1]
    assert sizes


# -- the registry ------------------------------------------------------------


def test_registry_names_and_capabilities_match_the_reference():
    assert arch.names() == ref_arch.names()
    assert [a.fig14_label for a in arch.fig14_archs()] == \
        [a.fig14_label for a in ref_arch.fig14_archs()]
    for name in arch.names():
        a, r = arch.get(name), ref_arch.get(name)
        assert a.capabilities() == r.capabilities(), name
        assert (a.description, a.paper, a.fig14_order) == (r.description, r.paper, r.fig14_order)
        assert [v.order for v in a.cost_variants] == [v.order for v in r.cost_variants]
        for v, rv in zip(a.cost_variants, r.cost_variants):
            same(v.build(cost.Prices()), rv.build(ref_cost.Prices()))
        if a.cost is not None:
            same(a.cost(), r.cost())
        if a.analytical is not None:
            cfg, rcfg = topology.RailXConfig(m=4, n=9, R=128), ref_topo.RailXConfig(m=4, n=9, R=128)
            for f in ("alltoall_per_chip",):
                if getattr(a.analytical, f) is not None:
                    assert getattr(a.analytical, f)(cfg) == getattr(r.analytical, f)(rcfg)
        if not r.has("job_network"):
            with pytest.raises(KeyError, match="job_network"):
                a.require("job_network")
    with pytest.raises(KeyError, match="unknown architecture"):
        arch.get("no-such-fabric")


@pytest.mark.parametrize("name", [n for n in ref_arch.names()
                                  if ref_arch.get(n).flow_fig14 is not None])
def test_fig14_flow_builds_match_the_reference(name):
    """Every Fig. 14 fabric's dict network: the same vertices, adjacency
    order (the BFS tie-breaker) and capacities, and the same chip list."""
    for scale, m in ((2, 2), (3, 2), (3, 3)):
        got = arch.get(name).flow_fig14(scale, m, 2.0, 8.0)
        want = ref_arch.get(name).flow_fig14(scale, m, 2.0, 8.0)
        assert dict(got.net.adj) == dict(want.net.adj)
        assert list(got.net.adj) == list(want.net.adj)
        assert got.net.capacity == want.net.capacity
        assert got.chips == want.chips


def test_registry_rejects_as_the_reference():
    reg = arch.ArchitectureRegistry()
    reg.register(arch.Architecture(name="x", description="x"))
    with pytest.raises(ValueError, match="already registered"):
        reg.register(arch.Architecture(name="x", description="x"))
    with pytest.raises(ValueError, match="fig14_label without flow_fig14"):
        reg.register(arch.Architecture(name="y", description="y", fig14_label="y"))
