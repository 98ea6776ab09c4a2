"""The flow-level simulator's CSR engine on the card (paper §6.1.2): the
port of ``repro/core/compiled_flow.py``.

A ``FlowNetwork`` (or a canonical builder) is lowered to integer vertex ids
+ CSR adjacency + per-edge capacity tensors on ``device`` (the card unless
the caller passes ``device="cpu"``), and the all-to-all sweeps behind Fig.
14 run as array work there, their hot loops in the hand-written kernels of
``kernels/flow`` (their plain PyTorch versions on CPU tensors):

* ``CompiledNetwork``        — the CSR lowering (``from_flow_network``,
  ``from_arrays``) plus direct builders (``build_compiled_railx_hyperx`` /
  ``build_compiled_torus2d`` / ``build_compiled_fattree``) that skip the
  dict representation and emit the reference's *canonical*,
  translation-invariant adjacency order;
* ``bfs_forest``             — batched BFS, one ``flow_bfs_level`` launch a
  level, whose tie-breaking (first discoverer in FIFO × adjacency order)
  is the seed ``deque`` BFS's: the trees equal the reference's, vertex
  for vertex;
* ``route_demands``          — path/load accounting; the demand-ordered
  edge stream is folded per edge in its order (``flow_ordered_fold``), so
  loads are **bit-identical** to the reference's at every ``num_paths``;
* ``alltoall_edge_counts``   — exact all-to-all sweeps via subtree
  counting (``flow_subtree_accumulate``): integer path counts per edge,
  with ``utilization_from_counts(..., sequential=True)`` converting counts
  to the seed's sequentially accumulated float loads through a strict
  left-to-right table — bit-identical to the reference;
* ``symmetric_alltoall_counts`` — the vertex-transitivity fast path: one
  representative source per automorphism class, each class's counts summed
  over the translation orbit (``flow_orbit_gather``) — O(N · classes)
  instead of O(N²), the paper's >100K-chip operating points.

All count arithmetic is int64 and exact, so the symmetry counts equal the
brute-force sweep's exactly.  The reference's scipy BFS (a host-only speed
path that gives the same trees) has no counterpart: every sweep runs here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Hashable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..kernels.flow import flow
from ..obs import get_tracer

Vertex = Hashable
INF = torch.iinfo(torch.int64).max
I64 = torch.int64


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Translation symmetry (canonical builders only)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TranslationSymmetry:
    """Node-translation automorphism group of a canonically-built topology.

    Vertex ids are laid out ``((X * scale + Y) * m² + chip)``; the group is
    translations ``(X, Y) -> (X + sx, Y + sy) mod scale`` for ``sx, sy``
    multiples of ``step``.  The canonical builders enumerate neighbors by
    translation-invariant offset descriptors, so the action preserves CSR
    *slots*: the image of edge ``(u, slot)`` is ``(π(u), slot)`` — which
    makes BFS trees of translated sources exact translates of each other
    and the symmetry sweep exact rather than approximate.
    """

    scale: int
    mesh: int
    step: int

    @property
    def chips_per_node(self) -> int:
        return self.mesh * self.mesh

    def group_elements(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sx, sy) int64 tensors enumerating the whole translation subgroup."""
        shifts = torch.arange(0, self.scale, self.step, dtype=I64, device=device)
        sx, sy = torch.meshgrid(shifts, shifts, indexing="ij")
        return sx.reshape(-1), sy.reshape(-1)

    def translate_vertices(self, v: torch.Tensor, sx, sy) -> torch.Tensor:
        """Vertex image under translation; broadcasts over ``v``/``sx``/``sy``."""
        m2 = self.chips_per_node
        node, chip = v // m2, v % m2
        X, Y = node // self.scale, node % self.scale
        return (((X + sx) % self.scale) * self.scale + (Y + sy) % self.scale) * m2 + chip


# ---------------------------------------------------------------------------
# Compiled network
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledNetwork:
    """CSR lowering of a directed capacitated flow graph, its tensors on one
    device.

    ``indptr``/``nbr`` hold the adjacency in the *same per-vertex order* as
    the source representation (insertion order for dict graphs, canonical
    offset order for direct builders): BFS tie-breaking — and therefore
    routing — is a function of that order.  The types are the reference's.
    """

    indptr: torch.Tensor                     # int64 [n+1]
    nbr: torch.Tensor                        # int32 [E], adjacency order
    cap: torch.Tensor                        # float64 [E]
    edge_src: torch.Tensor                   # int32 [E], CSR row of each edge
    vertex_of: Optional[List[Vertex]] = None
    vertex_id: Optional[Dict[Vertex, int]] = None
    symmetry: Optional[TranslationSymmetry] = None
    chip_ids: Optional[torch.Tensor] = None  # int64; default: every vertex is a chip
    star_core: Optional[int] = None          # fat-tree hub vertex, if any
    _rev: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False
    )                                        # lazy reverse-CSR tables

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def num_vertices(self) -> int:
        return self.indptr.numel() - 1

    @property
    def num_edges(self) -> int:
        return self.nbr.numel()

    def chips(self) -> torch.Tensor:
        if self.chip_ids is not None:
            return self.chip_ids
        return torch.arange(self.num_vertices, dtype=I64, device=self.device)

    @classmethod
    def from_flow_network(cls, net, device=None) -> "CompiledNetwork":
        """Lower a ``simulator.FlowNetwork`` preserving adjacency order."""
        verts = list(net.adj)
        vid = {v: i for i, v in enumerate(verts)}
        indptr = np.zeros(len(verts) + 1, np.int64)
        nbrs: List[int] = []
        caps: List[float] = []
        capacity = net.capacity
        for i, v in enumerate(verts):
            lst = net.adj[v]
            indptr[i + 1] = indptr[i] + len(lst)
            for w in lst:
                nbrs.append(vid[w])
                caps.append(capacity[(v, w)])
        edge_src = np.repeat(np.arange(len(verts), dtype=np.int32), np.diff(indptr))
        return cls.from_arrays(indptr, nbrs, caps, edge_src, vertex_of=verts, vertex_id=vid,
                               device=device)

    @classmethod
    def from_arrays(
        cls, indptr, nbr, cap, edge_src, *, chip_ids=None, symmetry=None,
        star_core: Optional[int] = None, vertex_of=None, vertex_id=None, device=None,
    ) -> "CompiledNetwork":
        """A network from host arrays — a reference ``CompiledNetwork``'s
        ``indptr``, ``nbr``, ``cap``, ``edge_src``, ``chip_ids`` and
        ``symmetry`` (anything with ``scale``, ``mesh`` and ``step``) — on
        ``device``, in the reference's types."""
        dev = _device.resolve(device)
        sym = None if symmetry is None else TranslationSymmetry(
            int(symmetry.scale), int(symmetry.mesh), int(symmetry.step))
        return cls(
            _tensor(indptr, I64, dev), _tensor(nbr, torch.int32, dev),
            _tensor(cap, torch.float64, dev), _tensor(edge_src, torch.int32, dev),
            vertex_of=vertex_of, vertex_id=vertex_id, symmetry=sym,
            chip_ids=None if chip_ids is None else _tensor(chip_ids, I64, dev),
            star_core=star_core,
        )


def _assemble_csr(n: int, src, key, dst, cap, **fields) -> CompiledNetwork:
    """CSR from per-block parallel edge tensors, per-vertex adjacency in
    (src, key) order — **without** a global sort.  (Traced as
    ``flow.csr_assemble`` when an ambient tracer is active.)

    Contract (every canonical builder below satisfies it): within each
    block, edges are sorted by (src, key); per source, key ranges ascend
    across blocks in list order; (src, key) pairs are globally unique.
    Placing each block's edges at ``indptr[src] + (edges of earlier blocks
    for that src) + (rank within this block's run of src)`` then gives the
    reference's canonical adjacency order.  The contract is enforced after
    placement: every edge inside its source's run, and keys strictly
    increasing within every run.
    """
    trc = get_tracer()
    if trc.enabled:
        with trc.span("flow.csr_assemble", cat="flow", vertices=n) as sp:
            cn = _assemble_csr_impl(n, src, key, dst, cap, **fields)
            sp.set(edges=cn.num_edges)
            return cn
    return _assemble_csr_impl(n, src, key, dst, cap, **fields)


def _assemble_csr_impl(n: int, src, key, dst, cap, **fields) -> CompiledNetwork:
    dev = src[0].device
    counts = [torch.bincount(s, minlength=n) for s in src]
    deg = torch.stack(counts).sum(0)
    indptr = torch.zeros(n + 1, dtype=I64, device=dev)
    torch.cumsum(deg, 0, out=indptr[1:])
    E = int(indptr[-1])
    nbr = torch.empty(E, dtype=torch.int32, device=dev)
    capa = torch.empty(E, dtype=torch.float64, device=dev)
    esrc = torch.full((E,), -1, dtype=torch.int32, device=dev)
    karr = torch.empty(E, dtype=I64, device=dev)
    base = indptr[:-1].clone()         # next free slot per source
    for s, k, d, c, cnt in zip(src, key, dst, cap, counts):
        if s.numel():
            # rank of each edge within its source's (contiguous) run
            runstart = torch.cumsum(cnt, 0) - cnt
            pos = base[s] + (torch.arange(s.numel(), dtype=I64, device=dev) - runstart[s])
            nbr[pos] = d.to(torch.int32)
            capa[pos] = c.to(torch.float64)
            esrc[pos] = s.to(torch.int32)
            karr[pos] = k
        base += cnt
    if E:
        if not torch.equal(esrc, torch.repeat_interleave(
                torch.arange(n, dtype=torch.int32, device=dev), deg)):
            raise AssertionError(
                "_assemble_csr block contract violated: a block's "
                "sources are not sorted (edge placed outside its run)"
            )
        run_start = torch.zeros(E, dtype=torch.bool, device=dev)
        run_start[indptr[:-1][deg > 0]] = True
        if not bool(torch.all(run_start[1:] | (torch.diff(karr) > 0))):
            raise AssertionError(
                "_assemble_csr block contract violated: keys are not "
                "strictly increasing within a vertex's adjacency run"
            )
    return CompiledNetwork(indptr, nbr, capa, esrc, **fields)


# ---------------------------------------------------------------------------
# Direct (canonical) builders — skip the dict graph entirely
# ---------------------------------------------------------------------------


def _mesh_edges(v, x, y, m: int, k_internal: float):
    """Intra-node m×m mesh links in canonical (-x, +x, -y, +y) slot order."""
    srcs, keys, dsts, caps = [], [], [], []
    for keyid, (mask, delta) in enumerate((
        (x > 0, -m), (x < m - 1, m), (y > 0, -1), (y < m - 1, 1),
    )):
        vv = v[mask]
        srcs.append(vv)
        keys.append(torch.full_like(vv, keyid))
        dsts.append(vv + delta)
        caps.append(torch.full(vv.shape, float(k_internal), dtype=torch.float64, device=v.device))
    return srcs, keys, dsts, caps


def _coords(scale: int, m: int, dev):
    m2 = m * m
    v = torch.arange(scale * scale * m2, dtype=I64, device=dev)
    y = v % m
    x = (v // m) % m
    node = v // m2
    return v, x, y, node // scale, node % scale


def build_compiled_railx_hyperx(
    scale: int, m: int, k_internal: float, links_per_pair: int = 2,
    validate: bool = True, device=None,
) -> CompiledNetwork:
    """Canonical chip-granularity RailX-HyperX (same topology/capacities as
    the ``railx-hyperx`` flow builder, adjacency in translation-invariant
    offset order so the network carries a ``TranslationSymmetry``)."""
    dev = _device.resolve(device)
    m2 = m * m
    n = scale * scale * m2
    v, x, y, X, Y = _coords(scale, m, dev)
    srcs, keys, dsts, caps = _mesh_edges(v, x, y, m, k_internal)
    d = torch.arange(1, scale, dtype=I64, device=dev)
    # row rails live on chips (r, 0); pair (a, b) carries one unit link on
    # chip row (a + b + l) % m per l < links_per_pair (§3.2)
    for phys in ("row", "col"):
        if phys == "row":
            mask = y == 0
            line, rail_chip = X[mask], x[mask]      # translate X, chip row r
            other = Y[mask]
        else:
            mask = x == 0
            line, rail_chip = Y[mask], y[mask]      # translate Y, chip col c
            other = X[mask]
        vv = v[mask]
        dest_line = (line[:, None] + d[None, :]) % scale
        pair_sum = line[:, None] + dest_line
        mult = torch.zeros(dest_line.shape, dtype=I64, device=dev)
        for l in range(links_per_pair):
            mult += (((pair_sum + l) % m) == rail_chip[:, None]).to(I64)
        if phys == "row":
            dst = (dest_line * scale + other[:, None]) * m2 + rail_chip[:, None] * m
            key = 4 + (d - 1)
        else:
            dst = (other[:, None] * scale + dest_line) * m2 + rail_chip[:, None]
            key = 4 + (scale - 1) + (d - 1)
        sel = mult > 0
        srcs.append(vv[:, None].expand(dst.shape)[sel])
        keys.append(key[None, :].expand(dst.shape)[sel])
        dsts.append(dst[sel])
        caps.append(mult[sel].to(torch.float64))
    step = m // math.gcd(m, 2)   # row pattern shifts by 2σ: need m | 2σ
    sym = TranslationSymmetry(scale, m, step) if scale % step == 0 else None
    cn = _assemble_csr(n, srcs, keys, dsts, caps, symmetry=sym)
    if validate and sym is not None:
        _validate_symmetry(cn)
    return cn


def build_compiled_torus2d(
    side: int, m: int, k_internal: float, validate: bool = True, device=None,
) -> CompiledNetwork:
    """Canonical chip-granularity 2D torus (same topology/capacities as the
    ``torus-2d`` flow builder); fully translation symmetric."""
    dev = _device.resolve(device)
    m2 = m * m
    n = side * side * m2
    v, x, y, X, Y = _coords(side, m, dev)
    srcs, keys, dsts, caps = _mesh_edges(v, x, y, m, k_internal)
    # one rail per chip row/col: +X on chips (l, m-1), +Y on chips (m-1, l)
    rails = (
        (y == m - 1, 4, lambda Xv, Yv, xv, yv:
            (((Xv + 1) % side) * side + Yv) * m2 + xv * m),
        (y == 0, 5, lambda Xv, Yv, xv, yv:
            (((Xv - 1) % side) * side + Yv) * m2 + xv * m + (m - 1)),
        (x == m - 1, 6, lambda Xv, Yv, xv, yv:
            (Xv * side + (Yv + 1) % side) * m2 + yv),
        (x == 0, 7, lambda Xv, Yv, xv, yv:
            (Xv * side + (Yv - 1) % side) * m2 + (m - 1) * m + yv),
    )
    for mask, keyid, dest in rails:
        vv = v[mask]
        srcs.append(vv)
        keys.append(torch.full_like(vv, keyid))
        dsts.append(dest(X[mask], Y[mask], x[mask], y[mask]))
        caps.append(torch.ones(vv.shape, dtype=torch.float64, device=dev))
    sym = TranslationSymmetry(side, m, 1)
    cn = _assemble_csr(n, srcs, keys, dsts, caps, symmetry=sym)
    if validate:
        _validate_symmetry(cn)
    return cn


def build_compiled_fattree(
    chips: int, ports: float = 1.0, taper: float = 1.0, device=None,
) -> CompiledNetwork:
    """Idealized fat-tree star (same abstraction as the dict builder):
    chips 0..N-1 plus a core hub; symmetric under any chip permutation,
    handled by the closed-form star case of the symmetry sweep."""
    dev = _device.resolve(device)
    n = chips + 1
    core = chips
    c = torch.arange(chips, dtype=I64, device=dev)
    hub = torch.full((chips,), core, dtype=I64, device=dev)
    caps = [torch.full((chips,), ports / taper, dtype=torch.float64, device=dev)] * 2
    return _assemble_csr(
        n, [c, hub], [torch.zeros_like(c), c], [hub, c], caps,
        chip_ids=c.clone(), star_core=core,
    )


def _validate_symmetry(cn: CompiledNetwork) -> None:
    """Check the generators really are slot-preserving automorphisms."""
    sym = cn.symmetry
    assert sym is not None
    e = torch.arange(cn.num_edges, dtype=I64, device=cn.device)
    u = cn.edge_src.to(I64)
    slot = e - cn.indptr[u]
    deg = torch.diff(cn.indptr)
    for sx, sy in ((sym.step, 0), (0, sym.step)):
        u2 = sym.translate_vertices(u, sx, sy)
        e2 = cn.indptr[u2] + slot
        if not (
            torch.equal(deg[u], deg[u2])
            and torch.equal(cn.cap[e2], cn.cap[e])
            and torch.equal(
                cn.nbr[e2].to(I64), sym.translate_vertices(cn.nbr.to(I64), sx, sy)
            )
        ):
            raise AssertionError(
                f"translation ({sx},{sy}) is not a slot-preserving "
                "automorphism of this network"
            )


# ---------------------------------------------------------------------------
# Batched BFS (seed-identical tie-breaking)
# ---------------------------------------------------------------------------


class _RevTables(NamedTuple):
    rev_indptr: torch.Tensor  # (n + 1,) int64: each vertex's in-edges
    rev_edge: torch.Tensor    # (E,) int64: their CSR ids, stably by head
    rev_src: torch.Tensor     # (E,) int32: their tails
    rev_slot: torch.Tensor    # (E,) int32: their slots in the tails' adjacency
    deg: torch.Tensor         # (n,) int64: out-degree << 32 | in-degree
    stride: int               # the largest slot + 2


def _reverse_tables(cn: CompiledNetwork) -> _RevTables:
    """Lazily-built reverse-CSR tables for bottom-up BFS levels, each
    in-edge's tail and slot gathered into that order, and the degrees the
    levels' direction test sums."""
    if cn._rev is None:
        n, E = cn.num_vertices, cn.num_edges
        rev_edge = torch.sort(cn.nbr, stable=True).indices
        in_deg = torch.bincount(cn.nbr, minlength=n)
        rev_indptr = torch.zeros(n + 1, dtype=I64, device=cn.device)
        torch.cumsum(in_deg, 0, out=rev_indptr[1:])
        edge_slot = torch.arange(E, dtype=I64, device=cn.device) - cn.indptr[cn.edge_src.to(I64)]
        stride = (int(edge_slot.max()) if E else 0) + 2
        deg = torch.diff(cn.indptr) * 2 ** 32 + in_deg
        cn._rev = _RevTables(rev_indptr, rev_edge, cn.edge_src[rev_edge].contiguous(),
                             edge_slot[rev_edge].to(torch.int32), deg, stride)
    return cn._rev


@dataclasses.dataclass
class _Forest:
    """A batched BFS as ``flow.bfs_level`` leaves it: the keys ``b * n + v``
    in one queue, the roots then level after level, each level in (source,
    parent, slot) order (the seed ``deque`` BFS's discovery order), each
    key's discovering CSR edge beside it, and ``child``: the queue position
    of each entry's first child, a CSR of the forest over queue positions
    (a parent's children are adjacent, and the levels follow each other)."""

    queue: torch.Tensor   # (B n,) int64; positions past bounds[-1] unused
    epos: torch.Tensor    # (B n,) int64; the roots' unset
    child: torch.Tensor   # (B n + 1,) int64
    bounds: List[int]     # queue position where each level starts, then the end
    depth: torch.Tensor   # (B n,) int32, -1 where unreached

    def level(self, d: int) -> Tuple[int, int]:
        """(first queue position, size) of level ``d``."""
        return self.bounds[d], self.bounds[d + 1] - self.bounds[d]


def _bfs_levels(
    cn: CompiledNetwork,
    srcs: torch.Tensor,
    edge_ok: Optional[torch.Tensor] = None,
) -> _Forest:
    """Level-by-level batched BFS core, one ``flow.bfs_level`` a level.

    Every undiscovered key takes the least ``rank(parent) * stride + slot``
    over its eligible in-edges from the frontier (rank = the parent's
    position in its level, slot = the edge's position in the parent's
    adjacency): the seed ``deque`` BFS's first discoverer in (frontier order
    × adjacency order), so trees match the reference vertex for vertex, and
    each new level is the winners in that order.  A level runs top-down or
    bottom-up by the reference's work test (the frontier's out-edges against
    the undiscovered keys' in-edges); both give the same winners.  The
    kernel ranks the winners itself and sums the degrees the test needs, so
    the host reads three integers a level and runs nothing else between the
    launches.
    """
    n = cn.num_vertices
    B = srcs.numel()
    size = B * n
    dev = cn.device
    rev = _reverse_tables(cn)
    rev_indptr, stride = rev.rev_indptr, rev.stride
    depth = torch.full((size,), -1, dtype=torch.int32, device=dev)
    rank = torch.full((size,), INF, dtype=I64, device=dev)
    win = torch.full((size,), INF, dtype=I64, device=dev)
    queue = torch.empty(size, dtype=I64, device=dev)
    epos = torch.empty(size, dtype=I64, device=dev)
    child = torch.empty(size + 1, dtype=I64, device=dev)
    scratch = flow.bfs_scratch(size, stride, dev)
    info = torch.empty(3, dtype=I64, device=dev)
    roots = torch.arange(B, dtype=I64, device=dev) * n + srcs
    queue[:B] = roots
    depth[roots] = 0
    rank[roots] = torch.arange(B, dtype=I64, device=dev)
    out_sum, in_sum = torch.stack([(cn.indptr[srcs + 1] - cn.indptr[srcs]).sum(),
                                   (rev_indptr[srcs + 1] - rev_indptr[srcs]).sum()]).tolist()
    unvisited = size - B
    unvis_in = B * cn.num_edges - in_sum
    bounds = [0, B]
    while unvisited:
        qs, F = bounds[-2], bounds[-1] - bounds[-2]
        flow.bfs_level(unvis_in < out_sum, len(bounds) - 1, queue, epos, child, qs, F, rank,
                       depth, win, cn.indptr, cn.nbr, rev_indptr, rev.rev_edge, rev.rev_src,
                       rev.rev_slot, rev.deg, edge_ok, out_sum, scratch, info, n, stride)
        new, out_sum, in_new = info.tolist()   # the one read a level
        if not new:
            break
        bounds.append(bounds[-1] + new)
        unvisited -= new
        unvis_in -= in_new
    child[bounds[-2]:] = bounds[-1]   # the last level has no children
    return _Forest(queue, epos, child, bounds, depth)


def _traced_bfs(cn: CompiledNetwork, srcs: torch.Tensor,
                edge_ok: Optional[torch.Tensor] = None) -> _Forest:
    """``_bfs_levels``, traced as ``flow.bfs`` when an ambient tracer is
    active."""
    trc = get_tracer()
    if trc.enabled:
        with trc.span("flow.bfs", cat="flow", sources=srcs.numel(), vertices=cn.num_vertices):
            return _bfs_levels(cn, srcs, edge_ok=edge_ok)
    return _bfs_levels(cn, srcs, edge_ok=edge_ok)


def bfs_forest(
    cn: CompiledNetwork,
    srcs: Sequence[int],
    edge_ok: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched BFS from ``srcs``; returns ``(parent_e, depth)`` of shape
    ``[B, n]``.  ``parent_e[b, v]`` is the CSR edge id entering ``v`` on
    the BFS tree of ``srcs[b]`` (-1 at the source / unreached); trees are
    identical to the reference's (see ``_bfs_levels``).  ``edge_ok`` (bool
    [E]) masks out edges (used by the multi-path ECMP).  Traced as
    ``flow.bfs`` when an ambient tracer is active.
    """
    n = cn.num_vertices
    srcs = _tensor(srcs, I64, cn.device)
    B = srcs.numel()
    f = _traced_bfs(cn, srcs, edge_ok)
    parent_e = torch.full((B * n,), -1, dtype=I64, device=cn.device)
    end = f.bounds[-1]
    parent_e[f.queue[B:end]] = f.epos[B:end]
    return parent_e.view(B, n), f.depth.view(B, n)


# ---------------------------------------------------------------------------
# Load accounting
# ---------------------------------------------------------------------------


def _fold(cn: CompiledNetwork, f: _Forest, dest: torch.Tensor, K: torch.Tensor) -> None:
    """Add the per-edge path counts of forest ``f`` to ``K``: level by
    level from the deepest, each entry's count is its destination weight
    ``dest[v]`` plus its children's counts, and its discovering edge carries
    that many paths (``flow.subtree_accumulate``; exact int64)."""
    cnt = torch.empty(f.bounds[-1], dtype=I64, device=cn.device)
    for d in range(len(f.bounds) - 2, 0, -1):
        qs, L = f.level(d)
        flow.subtree_accumulate(f.queue, f.epos, f.child, qs, L, dest, cnt, K, cn.num_vertices)


def _forest_of(cn: CompiledNetwork, parent_e: torch.Tensor, depth: torch.Tensor,
               srcs: torch.Tensor) -> _Forest:
    """The queue form of a forest given as ``(parent_e, depth)``: each
    level's keys grouped by their parent's queue position (torch sorts:
    no BFS runs here)."""
    B, n = depth.shape
    dev = cn.device
    size = B * n
    dflat = depth.reshape(-1)
    pe = parent_e.reshape(-1)
    queue = torch.empty(size, dtype=I64, device=dev)
    epos = torch.empty(size, dtype=I64, device=dev)
    child = torch.empty(size + 1, dtype=I64, device=dev)
    pos = torch.full((size,), -1, dtype=I64, device=dev)
    roots = torch.arange(B, dtype=I64, device=dev) * n + srcs
    queue[:B] = roots
    pos[roots] = torch.arange(B, dtype=I64, device=dev)
    bounds = [0, B]
    for lev in range(1, int(depth.max()) + 1):
        keys = torch.nonzero(dflat == lev).flatten()
        ppos = pos[keys - keys % n + cn.edge_src[pe[keys]].long()]
        ppos, order = torch.sort(ppos, stable=True)
        keys = keys[order]
        qs, prev = bounds[-1], bounds[-2]
        queue[qs:qs + keys.numel()] = keys
        epos[qs:qs + keys.numel()] = pe[keys]
        pos[keys] = qs + torch.arange(keys.numel(), dtype=I64, device=dev)
        counts = torch.bincount(ppos - prev, minlength=qs - prev)
        child[prev:qs] = qs + torch.cumsum(counts, 0) - counts
        bounds.append(qs + keys.numel())
    child[bounds[-2]:] = bounds[-1]
    return _Forest(queue, epos, child, bounds, depth.reshape(-1))


def subtree_edge_counts(
    cn: CompiledNetwork,
    parent_e: torch.Tensor,
    depth: torch.Tensor,
    srcs,
    dest_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Integer per-edge path counts for one BFS forest.

    ``counts[e]`` = number of (source, destination) pairs whose tree path
    crosses edge ``e``; destinations default to every vertex.  Computed
    by bottom-up subtree accumulation, one ``flow.subtree_accumulate`` a
    depth, over the forest put in queue order; exact int64 arithmetic.
    """
    n = depth.shape[1]
    dev = cn.device
    f = _forest_of(cn, parent_e, depth, _tensor(srcs, I64, dev))
    dest = (torch.ones(n, dtype=I64, device=dev) if dest_mask is None
            else _tensor(dest_mask, I64, dev))
    K = torch.zeros(cn.num_edges, dtype=I64, device=dev)
    _fold(cn, f, dest, K)
    return K


def alltoall_edge_counts(
    cn: CompiledNetwork,
    chips=None,
    batch: int = 1024,
) -> torch.Tensor:
    """Exact all-to-all sweep: for every ordered chip pair (s, t), walk
    the seed-identical shortest path and count traversals per edge.
    Computed by bottom-up subtree accumulation over batches of ``batch``
    sources; exact int64 counts (order-free, so the sweep chunks freely).
    Traced as ``flow.alltoall_counts`` when an ambient tracer is active."""
    chip_ids = cn.chips() if chips is None else _tensor(chips, I64, cn.device)
    trc = get_tracer()
    if trc.enabled:
        with trc.span(
            "flow.alltoall_counts", cat="flow", sources=int(chip_ids.numel())
        ):
            return _alltoall_edge_counts_impl(cn, chip_ids, batch)
    return _alltoall_edge_counts_impl(cn, chip_ids, batch)


def _alltoall_edge_counts_impl(
    cn: CompiledNetwork, chip_ids: torch.Tensor, batch: int
) -> torch.Tensor:
    n = cn.num_vertices
    dev = cn.device
    dest_mask = torch.zeros(n, dtype=I64, device=dev)
    dest_mask[chip_ids] = 1
    K = torch.zeros(cn.num_edges, dtype=I64, device=dev)
    for lo in range(0, chip_ids.numel(), batch):
        srcs = chip_ids[lo:lo + batch]
        B = srcs.numel()
        f = _bfs_levels(cn, srcs)
        unreached = f.depth.view(B, n)[:, chip_ids] < 0
        if bool(unreached.any()):
            b, t = torch.nonzero(unreached)[0].tolist()
            raise ValueError(
                f"unreachable {_vname(cn, int(srcs[b]))}->{_vname(cn, int(chip_ids[t]))}"
            )
        # bottom-up: cnt[key] = destinations in the subtree under key; the
        # discovering edge of key carries exactly cnt[key] paths
        _fold(cn, f, dest_mask, K)
    return K


def _vname(cn: CompiledNetwork, vid: int):
    return cn.vertex_of[vid] if cn.vertex_of is not None else int(vid)


def sequential_sum_table(x: float, kmax: int) -> np.ndarray:
    """``table[k-1]`` = adding ``x`` to 0.0 ``k`` times in sequence — the
    exact float the seed engine's ``load[e] += share`` loop produces for
    an edge crossed ``k`` times by equal shares.  Built on the host:
    ``np.add.accumulate`` is a strict left-to-right reduction, which
    ``torch.cumsum`` does not promise."""
    return np.add.accumulate(np.full(kmax, x, np.float64))


def utilization_from_counts(
    K: torch.Tensor, cap: torch.Tensor, per_pair: float, sequential: bool = True
) -> float:
    """Max link utilization from integer path counts.

    ``sequential=True`` reproduces the seed engine's float accumulation
    bit for bit (exact mode); ``sequential=False`` is the single-multiply
    form used by the symmetry sweep (and by its brute-force property
    check, so the two stay bit-comparable with each other).
    """
    loaded = K > 0
    if not bool(loaded.any()):
        return 0.0
    capl = cap[loaded]
    if bool((capl <= 0).any()):
        return float("inf")
    kl = K[loaded]
    if sequential:
        table = torch.from_numpy(sequential_sum_table(per_pair, int(kl.max()))).to(K.device)
        load = table[kl - 1]
    else:
        load = kl.to(torch.float64) * per_pair
    return float(torch.max(load / capl))


# ---------------------------------------------------------------------------
# Demand routing (dict-engine replacement)
# ---------------------------------------------------------------------------


def _path_edges(cn, parent_e, keys, dp, D: int) -> torch.Tensor:
    """[P, D] CSR edge ids of the tree path to each key ``b * n + t`` of a
    forest (``parent_e`` flat over its keys), destination back to source
    (-1 padding past its depth ``dp``, ``D`` the longest): row-major
    flattening yields the destination-major edge stream the seed loop
    accumulates in."""
    n = cn.num_vertices
    base = keys - keys % n
    cur = keys.clone()
    M = torch.full((keys.numel(), D), -1, dtype=I64, device=keys.device)
    for j in range(D):
        act = dp > j
        pe = torch.where(act, parent_e[cur], -1)
        M[:, j] = pe
        cur = torch.where(act, base + cn.edge_src[pe.clamp(min=0)].to(I64), cur)
    return M


# keys (sources x vertices) of one forest of ``route_demands`` at num_paths=1:
# a 1,024-vertex goodput network routes 4,096 sources at once, and a forest
# over a 16,384-chip network holds 256 of its sources
ROUTE_KEYS = 1 << 22
# forests ``route_demands`` has routed at num_paths=1, and their sources
ROUTE_FORESTS = {"forests": 0, "sources": 0}


def route_forest_counts() -> Dict[str, int]:
    return dict(ROUTE_FORESTS)


def reset_route_forest_counts() -> None:
    ROUTE_FORESTS.update(forests=0, sources=0)


def route_demands(
    cn: CompiledNetwork,
    demands: Dict[Tuple[int, int], float],
    num_paths: int = 1,
) -> torch.Tensor:
    """Per-edge load tensor (float64 [E]) routing ``demands`` (keyed by
    vertex *id* pairs) over ``num_paths`` successive shortest paths.

    The demand-ordered edge stream is folded per edge in its order
    (``flow.ordered_fold``), so every edge sees its contributions in the
    seed loop's order: bit-identical to the reference.  ``num_paths=1``
    routes the sources in forests of ``ROUTE_KEYS // n`` sources (one BFS
    and one path matrix a forest), which give the per-source trees and
    the same stream.  ``num_paths>=2``
    adds load-balanced ECMP: each successive BFS pass excludes links
    already used for the same source, and each demand splits evenly over
    the paths found (a destination unreachable without reusing links
    keeps fewer paths).  Traced as ``flow.route`` when an ambient tracer
    is active.
    """
    trc = get_tracer()
    if trc.enabled:
        with trc.span(
            "flow.route", cat="flow",
            demands=len(demands), num_paths=num_paths,
        ):
            return _route_demands_impl(cn, demands, num_paths)
    return _route_demands_impl(cn, demands, num_paths)


def _route_demands_impl(
    cn: CompiledNetwork,
    demands: Dict[Tuple[int, int], float],
    num_paths: int,
) -> torch.Tensor:
    dev = cn.device
    by_src: Dict[int, List[Tuple[int, float]]] = {}
    for (s, t), v in demands.items():
        if s != t and v > 0:
            by_src.setdefault(s, []).append((t, v))
    ids_parts: List[torch.Tensor] = []
    w_parts: List[torch.Tensor] = []
    if num_paths <= 1:
        _route_forests(cn, by_src, ids_parts, w_parts)
    else:
        for sid, lst in by_src.items():
            tids = torch.tensor([t for t, _ in lst], dtype=I64, device=dev)
            vals = torch.tensor([v for _, v in lst], dtype=torch.float64, device=dev)
            used = torch.zeros(cn.num_edges, dtype=torch.bool, device=dev)
            npaths = torch.zeros(tids.numel(), dtype=I64, device=dev)
            passes: List[Tuple[torch.Tensor, torch.Tensor]] = []
            for p in range(num_paths):
                edge_ok = None if p == 0 else ~used
                parent_e, depth = bfs_forest(cn, [sid], edge_ok=edge_ok)
                parent_e, depth = parent_e[0], depth[0]
                if p == 0:
                    _check_reachable(cn, depth, sid, tids)
                reach = torch.nonzero(depth[tids] >= 0).flatten()
                if reach.numel() == 0:
                    break
                dp = depth[tids[reach]]
                M = _path_edges(cn, parent_e, tids[reach], dp, int(dp.max()))
                mask = M >= 0
                ids = M[mask]
                didx = reach[:, None].expand(M.shape)[mask]
                used[ids] = True
                npaths[reach] += 1
                passes.append((ids, didx))
            for ids, didx in passes:
                ids_parts.append(ids)
                w_parts.append(vals[didx] / npaths[didx])
    if not ids_parts:
        return torch.zeros(cn.num_edges, dtype=torch.float64, device=dev)
    ids = torch.cat(ids_parts)
    sorted_ids, perm = torch.sort(ids, stable=True)
    off = torch.zeros(cn.num_edges + 1, dtype=I64, device=dev)
    torch.cumsum(torch.bincount(sorted_ids, minlength=cn.num_edges), 0, out=off[1:])
    return flow.ordered_fold(torch.cat(w_parts)[perm], off)


def _route_forests(cn, by_src, ids_parts, w_parts) -> None:
    """Single-path routing of every source in ``by_src`` (its order, each
    source's destinations in theirs): the sources in chunks of
    ``ROUTE_KEYS // n``, each chunk one ``bfs_forest`` (the trees are the
    per-source BFS's), one read of its pairs' reachability and longest
    path, and one path matrix over all its pairs.  The stream appended is
    the per-source loop's, pair by pair, edge by edge from the
    destination back."""
    n, dev = cn.num_vertices, cn.device
    srcs = list(by_src)
    per = max(1, ROUTE_KEYS // n)
    for lo in range(0, len(srcs), per):
        chunk = srcs[lo:lo + per]
        pairs = [(b, t, v) for b, sid in enumerate(chunk) for t, v in by_src[sid]]
        pb = torch.tensor([p[0] for p in pairs], dtype=I64, device=dev)
        tids = torch.tensor([p[1] for p in pairs], dtype=I64, device=dev)
        vals = torch.tensor([p[2] for p in pairs], dtype=torch.float64, device=dev)
        parent_e, depth = bfs_forest(cn, chunk)
        ROUTE_FORESTS["forests"] += 1
        ROUTE_FORESTS["sources"] += len(chunk)
        keys = pb * n + tids
        dp = depth.reshape(-1)[keys]
        bad, D = torch.stack([(dp < 0).any().to(I64), dp.max()]).tolist()
        if bad:
            i = int(torch.nonzero(dp < 0)[0])
            raise ValueError(
                f"unreachable {_vname(cn, chunk[int(pb[i])])}->{_vname(cn, int(tids[i]))}"
            )
        M = _path_edges(cn, parent_e.reshape(-1), keys, dp, D)
        mask = M >= 0
        ids_parts.append(M[mask])
        w_parts.append(vals[:, None].expand(M.shape)[mask])


def _check_reachable(cn, depth, sid, tids):
    bad = torch.nonzero(depth[tids] < 0).flatten()
    if bad.numel():
        raise ValueError(
            f"unreachable {_vname(cn, sid)}->{_vname(cn, int(tids[bad[0]]))}"
        )


def max_utilization_compiled(cn: CompiledNetwork, load: torch.Tensor) -> float:
    """Same float result as the seed ``max_utilization`` over a load dict:
    max over loaded edges of load/capacity, inf on a loaded zero-cap edge."""
    loaded = load > 0
    if not bool(loaded.any()):
        return 0.0
    capl = cn.cap[loaded]
    if bool((capl <= 0).any()):
        return float("inf")
    return float(torch.max(load[loaded] / capl))


# ---------------------------------------------------------------------------
# Symmetry fast path
# ---------------------------------------------------------------------------


def representative_sources(cn: CompiledNetwork) -> torch.Tensor:
    """One source per automorphism class: every chip of the node block
    ``X < step, Y < step`` (the group orbit of that block tiles the grid)."""
    sym = cn.symmetry
    if sym is None:
        raise ValueError("network has no translation symmetry")
    m2 = sym.chips_per_node
    steps = torch.arange(sym.step, dtype=I64, device=cn.device)
    X, Y = torch.meshgrid(steps, steps, indexing="ij")
    nodes = X.reshape(-1) * sym.scale + Y.reshape(-1)
    chips = torch.arange(m2, dtype=I64, device=cn.device)
    return (nodes[:, None] * m2 + chips[None, :]).reshape(-1)


def symmetric_alltoall_counts(cn: CompiledNetwork) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-to-all per-edge path counts via vertex transitivity.

    Routes one representative source per automorphism class in one batched
    BFS, folds the classes' counts into one table C, and sums it over the
    translation orbit of every representative edge ``e`` (edges out of the
    representative node block — one per edge orbit): ``L(e) = Σ_g
    C(π_g(e))`` (``flow.orbit_gather``).  Integer arithmetic, so the result
    equals the brute-force O(N²) sweep *exactly*.  Returns
    ``(rep_edge_ids, counts)``.  Traced as ``flow.symmetry_sweep`` (with a
    nested ``flow.orbit_gather``) when an ambient tracer is active.
    """
    trc = get_tracer()
    if trc.enabled:
        with trc.span(
            "flow.symmetry_sweep", cat="flow",
            vertices=cn.num_vertices, edges=cn.num_edges,
        ):
            return _symmetric_alltoall_counts_impl(cn)
    return _symmetric_alltoall_counts_impl(cn)


def _symmetric_alltoall_counts_impl(
    cn: CompiledNetwork,
) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = cn.device
    if cn.star_core is not None:
        # fat-tree star: source s loads its own uplink N-1 times and every
        # chip's downlink once; summed over sources each edge carries N-1
        nchips = cn.chips().numel()
        e = torch.arange(cn.num_edges, dtype=I64, device=dev)
        return e, torch.full((cn.num_edges,), nchips - 1, dtype=I64, device=dev)
    sym = cn.symmetry
    if sym is None:
        raise ValueError("network has no translation symmetry")
    reps = representative_sources(cn)
    # representative edges: all CSR edges out of the representative block
    bounds = cn.indptr[torch.stack([reps, reps + 1])].tolist()
    re = torch.cat([torch.arange(a, b, dtype=I64, device=dev) for a, b in zip(*bounds)])
    f = _traced_bfs(cn, reps)
    bad = torch.nonzero(f.depth.view(reps.numel(), -1) < 0)
    if bad.numel():
        raise ValueError(
            f"unreachable vertices from source {int(reps[bad[0, 0]])}"
        )
    C = torch.zeros(cn.num_edges, dtype=I64, device=dev)
    _fold(cn, f, torch.ones(cn.num_vertices, dtype=I64, device=dev), C)
    trc = get_tracer()
    if trc.enabled:
        trc.begin(
            "flow.orbit_gather", cat="flow",
            group=(sym.scale // sym.step) ** 2, rep_edges=int(re.numel()),
        )
    K = flow.orbit_gather(C, cn.indptr, re.numel(), sym.scale, sym.step, sym.chips_per_node)
    if trc.enabled:
        trc.end("flow.orbit_gather")
    return re, K


def symmetric_alltoall_throughput(
    cn: CompiledNetwork, injection_ports: float
) -> float:
    """All-to-all throughput per chip (Fig. 14 figure of merit) via the
    symmetry sweep — O(N · classes) instead of O(N²)."""
    nchips = cn.chips().numel()
    per_pair = injection_ports / (nchips - 1)
    re, K = symmetric_alltoall_counts(cn)
    util = utilization_from_counts(K, cn.cap[re], per_pair, sequential=False)
    if util <= 0:
        return injection_ports
    return injection_ports * min(1.0, 1.0 / util)


def alltoall_throughput_compiled(
    cn: CompiledNetwork,
    injection_ports: float,
    chips=None,
    batch: int = 256,
) -> float:
    """Exact-mode all-to-all throughput: bit-identical to the reference
    (same paths, same float accumulation) at any scale."""
    chip_ids = cn.chips() if chips is None else _tensor(chips, I64, cn.device)
    nchips = chip_ids.numel()
    if nchips < 2:
        return injection_ports
    per_pair = injection_ports / (nchips - 1)
    K = alltoall_edge_counts(cn, chip_ids, batch=batch)
    util = utilization_from_counts(K, cn.cap, per_pair, sequential=True)
    if util <= 0:
        return injection_ports
    return injection_ports * min(1.0, 1.0 / util)
