"""The port's flow-level simulator (``repro_torch.core.simulator`` and
``compiled_flow``, on the CPU through the plain versions of the
``kernels/flow`` kernels) against the reference's, at equality: CSR arrays,
BFS trees, integer link counts, loads and every throughput float bit for
bit, on the reference parity test's small shapes (RailX 4-16, torus 4-16,
m 2-3, fat-tree 24), the dict networks of every Fig. 14 fabric, a graph
with planted ties and an unreachable pair."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import arch as ref_arch  # noqa: E402
from repro.core import compiled_flow as R  # noqa: E402
from repro.core import simulator as RS  # noqa: E402
from repro.core.simulator import route_demands_ecmp_reference  # noqa: E402
from repro_torch import arch  # noqa: E402
from repro_torch.core import compiled_flow as P  # noqa: E402
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.kernels.flow import flow  # noqa: E402
from repro_torch.kernels.flow import ref as flow_ref  # noqa: E402

CPU = "cpu"
INJ = 8.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The sweeps are many small tensor ops, on which torch's thread pool
    only spins: one thread runs them faster and leaves the other cores to
    the test processes beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CANONICAL = [  # (id, builder name, args, kwargs)
    ("hyperx4", "build_compiled_railx_hyperx", (4, 2, 2.0), {}),
    ("hyperx5", "build_compiled_railx_hyperx", (5, 2, 2.0), {}),
    ("hyperx_m3", "build_compiled_railx_hyperx", (6, 3, 2.0), {}),
    ("hyperx_m3_odd", "build_compiled_railx_hyperx", (4, 3, 2.0), {}),   # no symmetry
    ("hyperx16", "build_compiled_railx_hyperx", (16, 2, 2.0), {}),
    ("hyperx8_lpp3", "build_compiled_railx_hyperx", (8, 2, 4.0, 3), {}),
    ("torus4", "build_compiled_torus2d", (4, 2, 2.0), {}),
    ("torus5", "build_compiled_torus2d", (5, 2, 2.0), {}),
    ("torus16", "build_compiled_torus2d", (16, 2, 2.0), {}),
    ("fattree", "build_compiled_fattree", (24,), {"ports": 8.0}),
]
SYMMETRIC = {"hyperx4", "hyperx5", "hyperx_m3", "hyperx16", "hyperx8_lpp3", "torus4", "torus5",
             "torus16", "fattree"}


def _pair(case):
    _, fn, args, kw = case
    return getattr(P, fn)(*args, **kw, device=CPU), getattr(R, fn)(*args, **kw)


def _eq(got, want, what=""):
    """A port tensor equal to a reference array: values and type."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == np.asarray(want).dtype, (what, got.dtype, np.asarray(want).dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _csr_equal(cn, rcn):
    for f in ("indptr", "nbr", "cap", "edge_src"):
        _eq(getattr(cn, f), getattr(rcn, f), f)
    _eq(cn.chips(), rcn.chips(), "chips")
    assert cn.star_core == rcn.star_core
    sym, rsym = cn.symmetry, rcn.symmetry
    assert (sym is None) == (rsym is None)
    if sym is not None:
        assert (sym.scale, sym.mesh, sym.step) == (rsym.scale, rsym.mesh, rsym.step)


@pytest.mark.parametrize("case", CANONICAL, ids=[c[0] for c in CANONICAL])
def test_canonical_builders_trees_and_counts_match_the_reference(case):
    """CSR arrays, the trees of every chip's BFS, the exact sweep's counts,
    the symmetry sweep's counts and both throughputs, all equal."""
    cn, rcn = _pair(case)
    _csr_equal(cn, rcn)
    chips = rcn.chips()
    parent_e, depth = P.bfs_forest(cn, chips)
    rparent_e, rdepth = R.bfs_forest(rcn, chips)
    _eq(parent_e, rparent_e, "parent_e")
    _eq(depth, rdepth, "depth")
    K = P.alltoall_edge_counts(cn, batch=100)
    _eq(K, R._alltoall_edge_counts_impl(rcn, chips, 1024), "counts")
    _eq(P.subtree_edge_counts(cn, parent_e, depth, torch.as_tensor(chips)),
        R.subtree_edge_counts(rcn, rparent_e, rdepth, chips), "subtree counts")
    assert P.alltoall_throughput_compiled(cn, INJ) == R.alltoall_throughput_compiled(rcn, INJ)
    if case[0] not in SYMMETRIC:
        with pytest.raises(ValueError, match="no translation symmetry"):
            P.symmetric_alltoall_counts(cn)
        return
    re, Ks = P.symmetric_alltoall_counts(cn)
    rre, rKs = R.symmetric_alltoall_counts(rcn)
    _eq(re, rre, "representative edges")
    _eq(Ks, rKs, "symmetry counts")
    _eq(K[re], rKs, "exact counts on the representatives")
    assert P.symmetric_alltoall_throughput(cn, INJ) == R.symmetric_alltoall_throughput(rcn, INJ)
    if cn.symmetry is not None:
        _eq(P.representative_sources(cn), R.representative_sources(rcn), "representatives")


@pytest.mark.parametrize("case", CANONICAL[:3] + CANONICAL[6:8], ids=lambda c: c[0])
def test_masked_bfs_and_ecmp_match_the_reference(case):
    """``edge_ok``-masked trees (a random mask that changes the trees) and
    ``route_demands`` at num_paths 1 and 2, loads bit for bit."""
    cn, rcn = _pair(case)
    rng = np.random.RandomState(0)
    ok = rng.rand(rcn.num_edges) < 0.7
    srcs = rng.choice(rcn.chips(), 8, replace=False)
    got = P.bfs_forest(cn, srcs, edge_ok=torch.as_tensor(ok))
    want = R.bfs_forest(rcn, srcs, edge_ok=ok)
    for g, w, what in zip(got, want, ("parent_e", "depth")):
        _eq(g, w, what)
    assert not np.array_equal(want[0], R.bfs_forest(rcn, srcs)[0])  # the mask bites
    chips = rcn.chips()
    demands = {}
    for _ in range(60):
        s, t = (int(x) for x in rng.choice(chips, 2, replace=False))
        demands[(s, t)] = demands.get((s, t), 0.0) + float(rng.rand() * 3.0)
    for num_paths in (1, 2):
        _eq(P.route_demands(cn, demands, num_paths), R.route_demands(rcn, demands, num_paths),
            f"loads num_paths={num_paths}")
    load = P.route_demands(cn, demands, 2)
    assert P.max_utilization_compiled(cn, load) == \
        R.max_utilization_compiled(rcn, R.route_demands(rcn, demands, 2))


FIG14 = [n for n in ref_arch.names() if ref_arch.get(n).flow_fig14 is not None]


@pytest.mark.parametrize("name", FIG14)
@pytest.mark.parametrize("scale", [3, 4])
def test_dict_networks_of_every_fig14_fabric_match_the_reference(name, scale):
    """``from_flow_network`` on the registry's Fig. 14 builders (dict
    insertion order kept), and ``alltoall_throughput`` on the dict network,
    exact and with ECMP, bit for bit."""
    fb = arch.get(name).flow_fig14(scale, 2, 2.0, INJ)
    rfb = ref_arch.get(name).flow_fig14(scale, 2, 2.0, INJ)
    cn = P.CompiledNetwork.from_flow_network(fb.net, device=CPU)
    rcn = R.CompiledNetwork.from_flow_network(rfb.net)
    for f in ("indptr", "nbr", "cap", "edge_src"):
        _eq(getattr(cn, f), getattr(rcn, f), f)
    assert cn.vertex_of == rcn.vertex_of and cn.vertex_id == rcn.vertex_id
    for num_paths in (1, 2):
        got = PS.alltoall_throughput(fb.net, fb.chips, INJ, num_paths=num_paths, device=CPU)
        assert got == RS.alltoall_throughput(rfb.net, rfb.chips, INJ, num_paths=num_paths)


def test_fig14_throughput_equals_the_seed_engine():
    """The exact sweep on the dict networks equals the reference's seed
    engine (its ``route_demands_ecmp_reference`` over the full demand
    matrix, the test oracle): the same bits, as the reference promises."""
    for name, scale, inj in (("railx-hyperx", 3, 8.0), ("railx-hyperx", 5, 4.0),
                             ("torus-2d", 5, 4.0)):
        fb = arch.get(name).flow_fig14(scale, 2, 2.0, inj)
        per_pair = inj / (len(fb.chips) - 1)
        demands = {(s, t): per_pair for s in fb.chips for t in fb.chips if s != t}
        util = RS.max_utilization(fb.net, route_demands_ecmp_reference(fb.net, demands))
        got = PS.alltoall_throughput(fb.net, fb.chips, inj, device=CPU)
        assert got == inj * min(1.0, 1.0 / util)


def test_route_demands_randomized_parity_with_the_seed_engine():
    """Randomized demand matrices on RailX / torus dict networks: the
    port's load dict equals the seed engine's (keys and float values)."""
    rng = random.Random(0xC0FFEE)
    for trial in range(12):
        scale = rng.randint(3, 5)
        name = "railx-hyperx" if trial % 2 else "torus-2d"
        fb = arch.get(name).build_flow(scale, 2, 2.0)
        demands = {}
        for _ in range(rng.randint(1, 40)):
            s, t = rng.sample(fb.chips, 2)
            demands[(s, t)] = demands.get((s, t), 0.0) + rng.random() * 3.0
        got = PS.route_demands_ecmp(fb.net, demands, device=CPU)
        want = dict(route_demands_ecmp_reference(fb.net, demands))
        assert got == want, trial
        assert PS.max_utilization(fb.net, got) == RS.max_utilization(fb.net, want)
        assert PS.route_demands_ecmp(fb.net, demands, 2, device=CPU) == \
            RS.route_demands_ecmp(fb.net, demands, 2)


def _planted_ties():
    """Source s reaches a, b, c in one hop; each of them reaches x and y (a
    tie of three parents at depth 2), and y also from z past x: the first
    discoverer in FIFO x adjacency order must win every tie."""
    net = PS.FlowNetwork()
    for u, v in (("s", "c"), ("s", "a"), ("s", "b"), ("b", "y"), ("a", "y"), ("c", "x"),
                 ("a", "x"), ("b", "x"), ("c", "y"), ("x", "z"), ("y", "z"), ("z", "w"),
                 ("x", "w")):
        net.add_link(u, v, 1.0 + len(u + v) % 3)
    return net


def test_planted_ties_break_as_the_seed_bfs():
    net = _planted_ties()
    cn = P.CompiledNetwork.from_flow_network(net, device=CPU)
    rcn = R.CompiledNetwork.from_flow_network(net)
    srcs = list(range(cn.num_vertices))
    for g, w, what in zip(P.bfs_forest(cn, srcs), R.bfs_forest(rcn, srcs), ("parent_e", "depth")):
        _eq(g, w, what)
    # the seed BFS's own trees: a path's second-to-last hop is its parent
    for s in net.vertices():
        paths = RS.shortest_paths_multi(net, s, net.vertices())
        for t, path in paths.items():
            if t != s:
                e = int(P.bfs_forest(cn, [cn.vertex_id[s]])[0][0, cn.vertex_id[t]])
                assert cn.vertex_of[int(cn.edge_src[e])] == path[-2]
    demands = {(s, t): 1.0 + i for i, (s, t) in enumerate(
        (s, t) for s in net.vertices() for t in net.vertices() if s != t)}
    assert PS.route_demands_ecmp(net, demands, device=CPU) == \
        dict(route_demands_ecmp_reference(net, demands))
    vertices = net.vertices()
    assert PS.alltoall_throughput(net, vertices, INJ, device=CPU) == \
        RS.alltoall_throughput(net, vertices, INJ)


@pytest.mark.parametrize("case", [("ties", ()), ("railx-hyperx", (3, 2, 2.0)),
                                  ("torus-2d", (4, 2, 2.0)), ("fat-tree-nonblocking", (24, 8.0))],
                         ids=lambda c: c[0])
def test_shortest_paths_multi_matches_the_reference(case):
    """The port's dict BFS gives the reference's path to every destination,
    from every source."""
    name, args = case
    if name == "ties":
        net = rnet = _planted_ties()
    else:
        net, rnet = arch.get(name).build_flow(*args).net, ref_arch.get(name).build_flow(*args).net
    vertices = net.vertices()
    assert vertices == rnet.vertices()
    for s in vertices:
        assert PS.shortest_paths_multi(net, s, vertices) == \
            RS.shortest_paths_multi(rnet, s, vertices), s


@pytest.mark.parametrize("args", [(2, 1.0, 1), (8, 1024.0, 2, 10.0, 1.0, 3, 2.0),
                                  (64, 4096.0, 4), (1024, 1.0e6, 6, 7.0, 0.5, 1, 0.5)])
def test_ring_allreduce_time_cycles_matches_the_reference(args):
    assert PS.ring_allreduce_time_cycles(*args) == RS.ring_allreduce_time_cycles(*args)


def test_unreachable_raises_like_the_reference():
    net = PS.FlowNetwork()
    net.add_link("a", "b", 1.0)
    net.add_link("c", "d", 1.0)
    for fn, args in ((PS.route_demands_ecmp, (net, {("a", "c"): 1.0})),
                     (PS.alltoall_throughput, (net, ["a", "b", "c"], 1.0)),
                     (PS.alltoall_throughput, (net, ["a", "b", "c"], 1.0, 2))):
        with pytest.raises(ValueError) as want:
            getattr(RS, fn.__name__)(*args)
        with pytest.raises(ValueError, match="unreachable") as got:
            fn(*args, device=CPU)
        assert str(got.value) == str(want.value)


def test_from_arrays_carries_a_reference_network_across():
    """The reference's arrays (and symmetry) fed to both engines: routing is
    checked apart from building."""
    rcn = R.build_compiled_railx_hyperx(6, 3, 2.0)
    cn = P.CompiledNetwork.from_arrays(rcn.indptr, rcn.nbr, rcn.cap, rcn.edge_src,
                                       chip_ids=rcn.chip_ids, symmetry=rcn.symmetry, device=CPU)
    _csr_equal(cn, rcn)
    _eq(P.alltoall_edge_counts(cn), R._alltoall_edge_counts_impl(rcn, rcn.chips(), 1024))
    _eq(P.symmetric_alltoall_counts(cn)[1], R.symmetric_alltoall_counts(rcn)[1])
    star = R.build_compiled_fattree(6, ports=2.0)
    cn = P.CompiledNetwork.from_arrays(star.indptr, star.nbr, star.cap, star.edge_src,
                                       chip_ids=star.chip_ids, star_core=star.star_core,
                                       device=CPU)
    assert P.symmetric_alltoall_throughput(cn, 2.0) == R.symmetric_alltoall_throughput(star, 2.0)


def test_assembly_contract_is_enforced():
    """A block whose sources are out of order, or whose keys repeat within a
    vertex's run, fails loudly, as in the reference."""
    t = lambda *x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    caps = [torch.ones(2, dtype=torch.float64)]
    with pytest.raises(AssertionError, match="not sorted"):
        P._assemble_csr(3, [t(1, 0)], [t(0, 0)], [t(2, 2)], caps)
    with pytest.raises(AssertionError, match="strictly increasing"):
        P._assemble_csr(3, [t(0, 0)], [t(1, 1)], [t(1, 2)], caps)


def test_sequential_table_and_utilization_match_the_reference():
    x = 8.0 / 4095
    np.testing.assert_array_equal(P.sequential_sum_table(x, 5000), R.sequential_sum_table(x, 5000))
    rng = np.random.RandomState(1)
    K = rng.randint(0, 3000, 500).astype(np.int64)
    cap = rng.choice([1.0, 2.0, 3.0], 500)
    for seq in (True, False):
        assert P.utilization_from_counts(torch.as_tensor(K), torch.as_tensor(cap), x, seq) == \
            R.utilization_from_counts(K, cap, x, seq)
    assert P.utilization_from_counts(torch.zeros(3, dtype=torch.int64), torch.ones(3), x) == 0.0


def _level_state(cn, B, qs, F, rng):
    """A random mid-BFS state of B sources before level 3: half the keys
    discovered, a frontier of F of them at depth 2 (sorted, so grouped by
    source) at queue[qs:], ranked by position, the rest at depth 1, ``win``
    INF at the undiscovered keys."""
    n = cn.num_vertices
    size = B * n
    depth = torch.as_tensor(np.where(rng.rand(size) < 0.5, -1, 1).astype(np.int32))
    fkeys = torch.as_tensor(np.sort(rng.choice(np.nonzero(depth.numpy() == 1)[0], F, False)))
    depth[fkeys] = 2
    queue = torch.as_tensor(rng.randint(0, size, size).astype(np.int64))
    queue[qs:qs + F] = fkeys
    rank = torch.full((size,), flow_ref.INF, dtype=torch.int64)
    rank[fkeys] = torch.arange(F)
    win = torch.where(depth == -1, flow_ref.INF, torch.as_tensor(rng.randint(0, 99, size)))
    return {"queue": queue, "epos": torch.full((size,), -7, dtype=torch.int64),
            "child": torch.full((size + 1,), -7, dtype=torch.int64), "rank": rank,
            "depth": depth, "win": win, "info": torch.full((3,), -7, dtype=torch.int64)}


def _run_level(cn, st, bottom_up, level, qs, F, edge_ok):
    rev = P._reverse_tables(cn)
    size = st["depth"].numel()
    flow.bfs_level(bottom_up, level, st["queue"], st["epos"], st["child"], qs, F, st["rank"],
                   st["depth"], st["win"], cn.indptr, cn.nbr, rev.rev_indptr, rev.rev_edge,
                   rev.rev_src, rev.rev_slot, rev.deg, edge_ok, 0,
                   flow.bfs_scratch(size, rev.stride, "cpu"), st["info"], cn.num_vertices,
                   rev.stride)


@pytest.mark.parametrize("seed", range(3))
def test_bfs_level_directions_give_the_same_winners(seed):
    """The plain ``bfs_level``: from one random state, the bottom-up and
    top-down levels give the same new level (keys, edges, depths, ranks),
    the same child offsets and sizes (both directions of the kernel must,
    too; the direction is only a matter of work); top-down leaves ``win``
    at the winners, bottom-up leaves it as it was."""
    cn = P.build_compiled_railx_hyperx(5, 2, 2.0, device=CPU)
    n, B, qs, F = cn.num_vertices, 4, 5, 30
    rng = np.random.RandomState(seed)
    st = _level_state(cn, B, qs, F, rng)
    ok = torch.as_tensor(rng.rand(cn.num_edges) < 0.8)
    out = []
    for bottom_up in (False, True):
        got = {k: v.clone() for k, v in st.items()}
        _run_level(cn, got, bottom_up, 3, qs, F, ok)
        out.append(got)
    new = int(out[0]["info"][0])
    assert new > 0
    for k in ("queue", "epos", "child", "rank", "depth", "info"):
        assert torch.equal(out[0][k], out[1][k]), k
    assert torch.equal(out[1]["win"], st["win"])
    fresh = out[0]["queue"][qs + F:qs + F + new]
    assert torch.equal(out[0]["win"][fresh] // P._reverse_tables(cn).stride,
                       torch.searchsorted(out[0]["child"][qs:qs + F],
                                          torch.arange(new) + qs + F, right=True) - 1)
    changed = out[0]["win"] != st["win"]
    assert torch.equal(torch.nonzero(changed).flatten(), fresh.sort().values)


def _levels_forced(cn, srcs, edge_ok, mode):
    """``_bfs_levels`` with the direction forced (or by the work test),
    level by level through ``bfs_level``."""
    n = cn.num_vertices
    B = len(srcs)
    size = B * n
    st = {"queue": torch.empty(size, dtype=torch.int64),
          "epos": torch.empty(size, dtype=torch.int64),
          "child": torch.empty(size + 1, dtype=torch.int64),
          "rank": torch.full((size,), flow_ref.INF, dtype=torch.int64),
          "depth": torch.full((size,), -1, dtype=torch.int32),
          "win": torch.full((size,), flow_ref.INF, dtype=torch.int64),
          "info": torch.empty(3, dtype=torch.int64)}
    roots = torch.arange(B) * n + torch.as_tensor(srcs)
    st["queue"][:B] = roots
    st["depth"][roots] = 0
    st["rank"][roots] = torch.arange(B)
    rev_indptr = P._reverse_tables(cn).rev_indptr
    out_sum = int((cn.indptr[roots % n + 1] - cn.indptr[roots % n]).sum())
    unvis_in = B * cn.num_edges - int((rev_indptr[roots % n + 1] - rev_indptr[roots % n]).sum())
    bounds, unvisited = [0, B], size - B
    while unvisited:
        bottom_up = {"top_down": False, "bottom_up": True}.get(mode, unvis_in < out_sum)
        qs, F = bounds[-2], bounds[-1] - bounds[-2]
        _run_level(cn, st, bottom_up, len(bounds) - 1, qs, F, edge_ok)
        new, out_sum, in_new = st["info"].tolist()
        if not new:
            break
        bounds.append(bounds[-1] + new)
        unvisited -= new
        unvis_in -= in_new
    st["child"][bounds[-2]:] = bounds[-1]
    return st, bounds


def _star_net(leaves=70):
    """A hub with ``leaves`` out-edges (two 64-bit mask words, more than a
    warp's 32 lanes) and a ring through its leaves back to it."""
    net = PS.FlowNetwork()
    for i in range(leaves):
        net.add_link("hub", f"x{i}", 1.0)
    for i in range(leaves):
        net.add_link(f"x{i}", f"x{(i + 7) % leaves}", 2.0)
    net.add_link("x3", "hub", 1.0)
    return net


LEVEL_NETS = {"ties": lambda: _planted_ties(), "star70": lambda: _star_net(),
              "hyperx5": lambda: arch.get("railx-hyperx").build_flow(3, 2, 2.0).net}


@pytest.mark.parametrize("masked", [False, True], ids=["all_edges", "edge_ok"])
@pytest.mark.parametrize("mode", ["top_down", "bottom_up", "work_test"])
@pytest.mark.parametrize("net", list(LEVEL_NETS))
def test_bfs_levels_match_the_reference_level_by_level(net, mode, masked):
    """The plain level function, each direction forced and by the work test,
    against the reference's ``_bfs_levels`` level by level: each level's
    keys and discovering edges in the seed BFS's order, the depths; the
    child offsets partition every level among its parents, in order."""
    flow_net = LEVEL_NETS[net]()
    cn = P.CompiledNetwork.from_flow_network(flow_net, device=CPU)
    rcn = R.CompiledNetwork.from_flow_network(flow_net)
    n = cn.num_vertices
    srcs = list(range(n))
    ok = np.random.RandomState(3).rand(cn.num_edges) < 0.75 if masked else None
    st, bounds = _levels_forced(cn, srcs, None if ok is None else torch.as_tensor(ok), mode)
    rlevels, visited = R._bfs_levels(rcn, np.asarray(srcs, np.int64), edge_ok=ok)
    assert len(bounds) - 2 == len(rlevels)
    depth = np.full(len(srcs) * n, -1, np.int32)
    depth[np.arange(len(srcs)) * n + np.asarray(srcs)] = 0
    for d, (keys, epos) in enumerate(rlevels, start=1):
        a, b = bounds[d], bounds[d + 1]
        _eq(st["queue"][a:b], keys.astype(np.int64), f"level {d} keys")
        _eq(st["epos"][a:b], epos, f"level {d} epos")
        depth[keys] = d
        # the children of entry q are child[q]..child[q + 1], all of the next
        # level, and each names q as its parent
        first = st["child"][bounds[d - 1]:a + 1]
        assert int(first[0]) == a and int(first[-1]) == b and bool((first.diff() >= 0).all())
        owner = torch.searchsorted(first, torch.arange(a, b), right=True) - 1 + bounds[d - 1]
        parent = st["queue"][owner]
        assert torch.equal(parent % n, cn.edge_src[st["epos"][a:b]].long())
        assert torch.equal(parent // n, st["queue"][a:b] // n)
    _eq(st["depth"], depth, "depth")
    assert np.array_equal(st["depth"].numpy() >= 0, visited)
    if net == "star70" and not masked:
        assert int(torch.diff(st["child"][:bounds[-1] + 1]).max()) == 70


@pytest.mark.parametrize("case", [CANONICAL[1], CANONICAL[3], CANONICAL[6]], ids=lambda c: c[0])
def test_level_ordered_fold_matches_the_reference(case):
    """The level-ordered plain fold over the port's BFS forest, with a
    destination mask, against the reference's ``subtree_edge_counts`` on
    its own forest; and the public function on the reference's
    ``(parent_e, depth)``."""
    cn, rcn = _pair(case)
    rng = np.random.RandomState(5)
    srcs = rng.choice(rcn.chips(), 9, replace=False)
    dest = (rng.rand(rcn.num_vertices) < 0.6).astype(np.int64)
    rparent_e, rdepth = R.bfs_forest(rcn, srcs)
    want = R.subtree_edge_counts(rcn, rparent_e, rdepth, srcs, dest)
    f = P._bfs_levels(cn, torch.as_tensor(srcs))
    K = torch.zeros(cn.num_edges, dtype=torch.int64)
    P._fold(cn, f, torch.as_tensor(dest), K)
    _eq(K, want, "fold")
    _eq(P.subtree_edge_counts(cn, torch.as_tensor(rparent_e), torch.as_tensor(rdepth), srcs,
                              torch.as_tensor(dest)), want, "subtree_edge_counts")


def test_ordered_fold_sums_each_run_left_to_right():
    w = torch.tensor([0.1, 1e16, 0.2, -1e16, 0.3, 0.7], dtype=torch.float64)
    off = torch.tensor([0, 4, 4, 6])
    got = flow_ref.ordered_fold_ref(w, off)
    assert got.tolist() == [((0.0 + 0.1) + 1e16 + 0.2) + -1e16, 0.0, (0.0 + 0.3) + 0.7]


# the orbit gather's kernel reads C once in CSR order as one column sum
# (kernels/flow/csrc/flow.cu orbit_kernel): at steps 1, 2 and 3 and on the
# torus, the bin it gives each edge, index_add_-ed over random counts
ORBIT_NETS = [("hyperx5", (5, 2, 2.0)), ("hyperx8_m4", (8, 4, 2.0)),
              ("hyperx_m3", (6, 3, 2.0)), ("hyperx12_m3", (12, 3, 2.0)), ("torus8", (8, 2, 2.0))]


def _orbit_bins(cn):
    """Each edge's representative edge as the kernel finds it: residue x0 =
    X mod step is a (G, P[x0]) matrix whose row X' per + k starts at edge
    per (X' R + B[x0]) + k P[x0], its column c going to B[x0] + c."""
    sym = cn.symmetry
    step, scale, m2 = sym.step, sym.scale, sym.chips_per_node
    per, row_v, ip = scale // step, scale * m2, cn.indptr
    P = [int(ip[x * row_v + step * m2] - ip[x * row_v]) for x in range(step)]
    B = [sum(P[:x]) for x in range(step)]
    R = sum(P)
    bins = torch.full((cn.num_edges,), -1, dtype=torch.int64)
    for x0 in range(step):
        Xp, k = torch.arange(per)[:, None, None], torch.arange(per)[None, :, None]
        c = torch.arange(P[x0])[None, None, :]
        e = (per * (Xp * R + B[x0]) + k * P[x0] + c).flatten()
        assert (bins[e] == -1).all()   # no edge twice
        bins[e] = (B[x0] + c).expand(per, per, -1).flatten()
    assert (bins >= 0).all()           # every edge once
    return bins, R


@pytest.mark.parametrize("net", ORBIT_NETS, ids=lambda c: c[0])
def test_orbit_kernel_bins_sum_to_the_plain_orbit_gather(net):
    """ROADMAP Queue 2 item 15: the identity the orbit kernel rests on.  The
    kernel's bin of every edge, summed over random int64 counts with
    ``index_add_``, equals ``ref.orbit_gather_ref`` on the symmetry sweep's
    own inputs (representative edges, the translation group)."""
    name, args = net
    build = P.build_compiled_torus2d if name.startswith("torus") else P.build_compiled_railx_hyperx
    cn = build(*args, device=CPU)
    sym = cn.symmetry
    assert sym.step == {"hyperx8_m4": 2, "hyperx_m3": 3, "hyperx12_m3": 3}.get(name, 1)
    bins, R = _orbit_bins(cn)
    reps = P.representative_sources(cn)
    re = torch.cat([torch.arange(int(cn.indptr[r]), int(cn.indptr[r + 1])) for r in reps])
    re_u = cn.edge_src[re].long()
    sx, sy = sym.group_elements(CPU)
    assert re.numel() == R
    C = torch.from_numpy(np.random.RandomState(11).randint(-2 ** 40, 2 ** 40, cn.num_edges))
    want = flow_ref.orbit_gather_ref(C, cn.indptr, re_u, re - cn.indptr[re_u], sx, sy,
                                     sym.scale, sym.chips_per_node)
    assert torch.equal(torch.zeros(R, dtype=torch.int64).index_add_(0, bins, C), want)
    if sym.step == 1:   # the library call the kernel is timed against
        assert torch.equal(C.view(-1, R).sum(0), want)


@pytest.mark.parametrize("net", ORBIT_NETS, ids=lambda c: c[0])
def test_orbit_gather_takes_the_count_of_representative_edges(net):
    """ROADMAP Queue 2 item 15: ``flow.orbit_gather(C, indptr, R, scale,
    step, m2)`` needs no index tensors.  The plain version's,
    ``ref.orbit_operands``, equal the symmetry sweep's representative edges
    (sources, slots) and the translation group, and the wrapper gives the
    gather over them."""
    name, args = net
    build = P.build_compiled_torus2d if name.startswith("torus") else P.build_compiled_railx_hyperx
    cn = build(*args, device=CPU)
    sym = cn.symmetry
    reps = P.representative_sources(cn)
    re = torch.cat([torch.arange(int(cn.indptr[r]), int(cn.indptr[r + 1])) for r in reps])
    re_u = cn.edge_src[re].long()
    sx, sy = sym.group_elements(CPU)
    ops = flow_ref.orbit_operands(cn.indptr, sym.scale, sym.step, sym.chips_per_node)
    for got, want in zip(ops, (re_u, re - cn.indptr[re_u], sx, sy)):
        assert torch.equal(got, want)
    C = torch.from_numpy(np.random.RandomState(5).randint(0, 2 ** 40, cn.num_edges))
    want = flow_ref.orbit_gather_ref(C, cn.indptr, re_u, re - cn.indptr[re_u], sx, sy,
                                     sym.scale, sym.chips_per_node)
    got = flow.orbit_gather(C, cn.indptr, re.numel(), sym.scale, sym.step, sym.chips_per_node)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", [dict(R=-1), dict(R=1), dict(cut=4), dict(step=3),
                                 dict(step=0)], ids=["R_short", "R_long", "vertices", "step_3",
                                                     "step_0"])
def test_orbit_gather_rejects_what_is_not_a_translation_orbit(bad):
    """ROADMAP Queue 2 item 15: an ``R`` other than the representative
    edges (``E != (scale / step)^2 R``), an ``indptr`` of other than
    ``scale^2 m2`` vertices or a ``step`` that does not divide ``scale``
    raises, on the CPU as on the card, before anything is read."""
    cn = P.build_compiled_railx_hyperx(8, 4, 2.0, device=CPU)
    sym = cn.symmetry
    R = cn.num_edges // (sym.scale // sym.step) ** 2
    args = dict(C=torch.zeros(cn.num_edges, dtype=torch.int64),
                indptr=cn.indptr[:cn.indptr.numel() - bad.get("cut", 0)],
                R=R + bad.get("R", 0), scale=sym.scale, step=bad.get("step", sym.step),
                m2=sym.chips_per_node)
    with pytest.raises(ValueError, match=r"E = \(scale / step\)\^2 R"):
        flow.orbit_gather(**args)


def _mixed_demands(chips, seed, sources):
    """Demands from ``sources`` chips, inserted in a shuffled order, so that
    each source's destinations come in an order of their own."""
    rng = np.random.RandomState(seed)
    srcs = [int(s) for s in rng.choice(chips, sources, replace=False)]
    pairs = [(s, int(t)) for s in srcs for t in rng.choice(chips, 9, replace=False) if t != s]
    return {pairs[i]: float(rng.rand() * 4 + 0.25) for i in rng.permutation(len(pairs))}


@pytest.mark.parametrize("per_forest", [None, 3, 1], ids=["one_forest", "forests_of_3",
                                                           "forests_of_1"])
@pytest.mark.parametrize("net", ["hyperx5", "torus5", "dict_railx4"])
def test_route_demands_in_forests_matches_the_reference(net, per_forest, monkeypatch):
    """ROADMAP Queue 2 item 15: ``route_demands`` at num_paths=1 routes a
    chunk of sources a forest (``ROUTE_KEYS`` keys; lowered here to force
    forests of 3 sources and of 1); its loads equal the reference's
    ``route_demands`` bit for bit, one ``bfs_forest`` a chunk."""
    if net == "dict_railx4":
        fnet = arch.get("railx-hyperx").build_flow(4, 2, 2.0).net
        cn = P.CompiledNetwork.from_flow_network(fnet, device=CPU)
        rcn = R.CompiledNetwork.from_flow_network(fnet)
    else:
        cn, rcn = _pair(next(c for c in CANONICAL if c[0] == net))
    from repro_torch.obs import Tracer, tracing

    n = cn.num_vertices
    if per_forest is not None:
        monkeypatch.setattr(P, "ROUTE_KEYS", per_forest * n)
    demands = _mixed_demands(rcn.chips(), 7, 8)
    P.reset_route_forest_counts()
    tracer = Tracer(process="route")
    with tracing(tracer):
        got = P.route_demands(cn, demands)
    want = R.route_demands(rcn, demands)
    np.testing.assert_array_equal(got.numpy().view(np.int64), want.view(np.int64))
    chunks = ([8] if per_forest is None else
              [per_forest] * (8 // per_forest) + [8 % per_forest] * (8 % per_forest > 0))
    assert [e["args"]["sources"] for e in tracer.events
            if e["name"] == "flow.bfs" and e["ph"] == "B"] == chunks
    assert P.route_forest_counts() == {"forests": len(chunks), "sources": 8}


def test_goodput_of_a_job_of_128_sources_matches_the_reference(monkeypatch):
    """ROADMAP Queue 2 item 15: a whole ``estimate_goodput`` whose miss
    routes 128 sources (qwen3-8b at tp 16, dp 8, pp 16 on 16 x 8 nodes),
    in one forest and in forests of 40, equals the reference's float."""
    import repro.cluster as ref_cluster
    from repro.core import availability as ref_avail, topology as ref_topo
    from repro.core.mapping import ParallelismPlan as RefPlan
    from repro_torch import cluster
    from repro_torch.core import availability, topology
    from repro_torch.core.mapping import ParallelismPlan

    plan = dict(tp=16, cp=1, ep=1, dp=8, pp=16)
    cfg, rcfg = topology.RailXConfig(m=4, n=4, R=64), ref_topo.RailXConfig(m=4, n=4, R=64)
    job = cluster.make_job(0, "qwen3-8b", plan=ParallelismPlan(**plan))
    rjob = ref_cluster.make_job(0, "qwen3-8b", plan=RefPlan(**plan))
    jm, rjm = cluster.plan_job_mapping(cfg, job), ref_cluster.plan_job_mapping(rcfg, rjob)
    rows, cols = tuple(range(jm.rows_req)), tuple(range(jm.cols_req))
    want = ref_cluster.estimate_goodput(rcfg, rjob, rjm.mapping,
                                        ref_avail.JobAllocation(rows, cols), max_flow_nodes=64)
    for keys, forests in ((P.ROUTE_KEYS, 1), (40 * 128, 4)):  # n = 128: 128 or 40, 40, 40, 8
        monkeypatch.setattr(P, "ROUTE_KEYS", keys)
        P.reset_route_forest_counts()
        got = cluster.estimate_goodput(cfg, job, jm.mapping, availability.JobAllocation(rows, cols),
                                       max_flow_nodes=64, device="cpu")
        assert got == want and 0 < want < 1
        assert P.route_forest_counts() == {"forests": forests, "sources": 128}
