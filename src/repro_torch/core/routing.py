"""Point-to-point routing on RailX (paper §4.1).

The port's own copy of ``repro/core/routing.py`` (plain Python on plain
values; no tensors, no device).  It imports nothing of ``repro``.

Chips are addressed (X, Y, x, y): node coordinate (X, Y) in the logical 2D
topology and chip coordinate (x, y) in the node's m x m mesh.

* ``minimal_route`` implements Algorithm 1 (deterministic X-rail-first
  minimal routing) including the on-mesh detours to reach the chip that
  carries the inter-node link, with the paper's VC discipline (VC increases
  at each node hop -> deadlock-free with d_o + 1 VCs).
* ``nonminimal_route`` implements §4.1.2: a bounded number of "free"
  hops (each bumping the VC) combined with XY-Torus sub-routing that reuses
  one VC — total VC count a + 1 for a >= d_o free hops.
* ``mesh_route`` is dimension-order (XY) routing on the intra-node mesh.

Hop objects carry (kind, vc) so tests can check the deadlock-freedom
discipline (VC strictly increases across inter-node hops; intra-mesh hops
reuse the current VC).
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Sequence, Tuple

Chip = Tuple[int, int, int, int]  # (X, Y, x, y)


@dataclasses.dataclass(frozen=True)
class Hop:
    kind: Literal["mesh", "xrail", "yrail"]
    src: Chip
    dst: Chip
    vc: int


@dataclasses.dataclass(frozen=True)
class RoutingParams:
    m: int                      # node mesh side
    scale_x: int                # nodes along X dimension of logical topology
    scale_y: int
    topology: Literal["hyperx", "torus"] = "hyperx"


def mesh_route(X: int, Y: int, src: Tuple[int, int], dst: Tuple[int, int], vc: int) -> List[Hop]:
    """Dimension-order routing on the intra-node 2D-mesh."""
    hops: List[Hop] = []
    x, y = src
    while x != dst[0]:
        nx = x + (1 if dst[0] > x else -1)
        hops.append(Hop("mesh", (X, Y, x, y), (X, Y, nx, y), vc))
        x = nx
    while y != dst[1]:
        ny = y + (1 if dst[1] > y else -1)
        hops.append(Hop("mesh", (X, Y, x, y), (X, Y, x, ny), vc))
        y = ny
    return hops


def _rail_port_chip(m: int, target_index: int, axis: Literal["x", "y"], cur: Tuple[int, int]) -> Tuple[int, int]:
    """The chip in the node carrying the rail link used to reach logical
    neighbor index ``target_index``.

    Rails of the X dimension are spread across the m chip-rows (rail a lives
    on chip-row a % m); choosing the rail nearest the current chip keeps the
    detour <= m/2 - 1 hops (paper's diameter argument).  We model the
    paper's "choose the nearest inter-node link" by picking the port row
    (resp. column) closest to the current chip position among those serving
    the destination rail group.
    """
    # rails serving any given destination are available on every chip
    # row/column (n ports per chip edge); nearest = current row/col when
    # possible, tie-broken toward the target's hashed rail row.
    pref = target_index % m
    if axis == "x":
        return (pref, cur[1]) if pref != cur[0] else cur
    return (cur[0], pref) if pref != cur[1] else cur


def _hyperx_next(cur: int, dst: int, scale: int) -> int:
    """In HyperX a single rail hop reaches any coordinate in the dimension."""
    return dst


def _torus_next(cur: int, dst: int, scale: int) -> int:
    fwd = (dst - cur) % scale
    bwd = (cur - dst) % scale
    return (cur + 1) % scale if fwd <= bwd else (cur - 1) % scale


def minimal_route(p: RoutingParams, src: Chip, dst: Chip) -> List[Hop]:
    """Algorithm 1: X-rail-first deterministic minimal routing."""
    hops: List[Hop] = []
    X, Y, x, y = src
    Xd, Yd, xd, yd = dst
    vc = 0
    step = _hyperx_next if p.topology == "hyperx" else _torus_next
    # X dimension
    while X != Xd:
        nX = step(X, Xd, p.scale_x)
        port = _rail_port_chip(p.m, nX, "x", (x, y))
        hops += mesh_route(X, Y, (x, y), port, vc)
        x, y = port
        hops.append(Hop("xrail", (X, Y, x, y), (nX, Y, x, y), vc + 1))
        X = nX
        vc += 1
    # Y dimension
    while Y != Yd:
        nY = step(Y, Yd, p.scale_y)
        port = _rail_port_chip(p.m, nY, "y", (x, y))
        hops += mesh_route(X, Y, (x, y), port, vc)
        x, y = port
        hops.append(Hop("yrail", (X, Y, x, y), (X, nY, x, y), vc + 1))
        Y = nY
        vc += 1
    hops += mesh_route(X, Y, (x, y), (xd, yd), vc)
    return hops


def nonminimal_route(
    p: RoutingParams,
    src: Chip,
    dst: Chip,
    via: Sequence[Tuple[int, int]],
) -> List[Hop]:
    """§4.1.2: route through intermediate nodes ``via`` (free/adaptive hops,
    VC bump each), then finish with XY-Torus-style minimal routing.  The VC
    count is len(via) + minimal VCs — callers bound len(via) = a."""
    hops: List[Hop] = []
    cur = src
    for (VX, VY) in via:
        leg = minimal_route(p, cur, (VX, VY, cur[2], cur[3]))
        base = hops[-1].vc if hops else 0
        hops += [Hop(h.kind, h.src, h.dst, h.vc + base) for h in leg]
        cur = (VX, VY, cur[2], cur[3])
    leg = minimal_route(p, cur, dst)
    base = hops[-1].vc if hops else 0
    hops += [Hop(h.kind, h.src, h.dst, h.vc + base) for h in leg]
    return hops


# ---------------------------------------------------------------------------
# Diameter / VC analyses (paper claims)
# ---------------------------------------------------------------------------


def count_hops(hops: Sequence[Hop]) -> Tuple[int, int]:
    """(external optical hops H_o, internal mesh hops H_i)."""
    ho = sum(1 for h in hops if h.kind in ("xrail", "yrail"))
    hi = sum(1 for h in hops if h.kind == "mesh")
    return ho, hi


def hyperx_diameter_bound(m: int) -> Tuple[int, int]:
    """Paper: 2D-HyperX diameter <= 2 H_o + (5m - 6) H_i."""
    return 2, 5 * m - 6


def max_vc(hops: Sequence[Hop]) -> int:
    return max((h.vc for h in hops), default=0)


def verify_deadlock_discipline(hops: Sequence[Hop]) -> None:
    """VC must be non-decreasing along the route and strictly increase at
    every inter-node (rail) hop — the paper's sufficient condition for
    deadlock freedom of minimal routing."""
    vc = 0
    for h in hops:
        if h.vc < vc:
            raise AssertionError(f"VC decreased: {h}")
        if h.kind in ("xrail", "yrail") and h.vc <= vc - 1:
            raise AssertionError(f"rail hop without VC bump: {h}")
        vc = h.vc


def route_length_cycles(
    hops: Sequence[Hop], hop_latency_ext: float = 10.0, hop_latency_int: float = 1.0
) -> float:
    ho, hi = count_hops(hops)
    return ho * hop_latency_ext + hi * hop_latency_int
