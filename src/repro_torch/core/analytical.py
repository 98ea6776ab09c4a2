"""Hardware-validated analytical communication model (paper §4.2, §6.1.1).

The port's own copy of ``repro/core/analytical.py`` (plain Python on plain
values; no tensors, no device).  It imports nothing of ``repro``.

All times are in seconds given bandwidths in bytes/s and latencies in
seconds; the paper's figures use normalized units — callers pick units.

Symbols (paper §3.2/§4.2):
    m   node mesh side (m x m chips per node)
    n   off-package ports per chip edge
    k   on-package / off-package bandwidth multiple
    p   nodes per topology dimension
    B   bandwidth per port (one direction)
    V   data volume per chip participating in the collective
    alpha  per-hop step latency (inter-node optical hop unless noted)

Equations implemented:
    Eq. 2  T_torus all-to-all throughput/chip        (2D-Torus)
    Eq. 3  T_hyperx all-to-all throughput/chip       (2D-HyperX)
    Eq. 4  T_dragonfly all-to-all throughput/chip    (Dragonfly)
    Eq. 6  T_R ring reduce-scatter/all-gather
    Eq. 7  T_2D-Ring all-reduce on m^2 x p x p RailX
    Eq. 8  T_RailX hierarchical all-reduce
    Eq. 9  T_1D / T_2D node-level all-reduce (TP on mesh)
    Eq.12  T_AR all-to-all-based reduce-scatter+all-gather step
    Eq.13  T_2D-HyperX all-to-all-based all-reduce
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence


# ---------------------------------------------------------------------------
# All-to-all bisection throughput (per chip), Eqs. 2-4
# ---------------------------------------------------------------------------


def alltoall_throughput_torus(R: int, m: int, n: int) -> float:
    """Eq. 2: per-chip all-to-all throughput upper bound, 2D-Torus, in units
    of per-port bandwidth."""
    return 16 * n / (R * m)


def alltoall_throughput_hyperx(m: int, n: int) -> float:
    """Eq. 3 (approx form): 2n/m."""
    return 2 * n / m


def alltoall_throughput_dragonfly(m: int, n: int) -> float:
    """Eq. 4 (approx form): 2n/m."""
    return 2 * n / m


# ---------------------------------------------------------------------------
# Ring / hierarchical All-Reduce, Eqs. 6-9, 12-13
# ---------------------------------------------------------------------------


def t_ring_phase(p: int, V: float, B: float, alpha: float) -> float:
    """Eq. 6: bidirectional-ring reduce-scatter OR all-gather time:
    T_R(p, V, B) = (p-1) alpha + (p-1)/p * V / (2B)."""
    if p <= 1:
        return 0.0
    return (p - 1) * alpha + (p - 1) / p * V / (2 * B)


def t_allreduce_ring(p: int, V: float, B: float, alpha: float) -> float:
    """Full ring all-reduce = reduce-scatter + all-gather."""
    return 2 * t_ring_phase(p, V, B, alpha)


def t_allreduce_2d_ring(
    m: int, p: int, V: float, nB: float, alpha: float
) -> float:
    """Eq. 7: 2D-ring all-reduce on the m^2 x p x p RailX: data split in two
    chunks processed simultaneously along X and Y rings of length mp.

    T = 2 [ T_R(mp, V/2, nB) + T_R(mp, V/(2mp), nB) ]
    (exact form; the paper then approximates ~ 4 mp alpha + V/(2 nB))."""
    return 2 * (
        t_ring_phase(m * p, V / 2, nB, alpha)
        + t_ring_phase(m * p, V / (2 * m * p), nB, alpha)
    )


def t_allreduce_hierarchical(
    m: int, p: int, V: float, nB: float, alpha: float, k: float,
    alpha_int: float = 0.0,
) -> float:
    """Eq. 8: RailX hierarchical all-reduce on m^2 x p x p.

    Phase 1: local reduce-scatter on the 2D-mesh at bandwidth k*nB
             (counted with the matching local all-gather as 2 * V/(2 k nB)),
    Phase 2: 2D-ring all-reduce across p x p nodes of V/m^2 per chip at
             per-chip inter-node bandwidth nB/m (m local ranks share rails),
    Phase 3: local all-gather (folded into the factor 2 of phase 1).

    T ~= 4 p alpha + (2/k + 1/m) * V / (2 nB)   [paper's approx]
    Exact assembled form below (keeps the (p-1)/p and (m^2-1)/m^2 factors).
    """
    local = 2 * ((m * m - 1) / (m * m)) * V / (2 * k * nB) + 2 * (m * m - 1) * alpha_int
    global_2d = 2 * (
        t_ring_phase(p, (V / (m * m)) / 2, nB / m, alpha)
        + t_ring_phase(p, (V / (m * m)) / (2 * p), nB / m, alpha)
    )
    return local + global_2d


def t_allreduce_node_level(
    dims: int, p: int, V: float, nB: float, alpha: float, m: int
) -> float:
    """Eq. 9: node-level all-reduce when TP occupies the mesh; inter-node
    bandwidth per chip is nB/m.  dims in {1, 2}."""
    if dims == 1:
        return 2 * t_ring_phase(p, V, nB / m, alpha)
    return 2 * (
        t_ring_phase(p, V / 2, nB / m, alpha)
        + t_ring_phase(p, V / (2 * p), nB / m, alpha)
    )


def t_ar_a2a_phase(p: int, V: float, B: float, alpha: float) -> float:
    """Eq. 12: all-to-all-based reduce-scatter or all-gather: single step,
    T_AR(p, V, B) = alpha + (p-1)/p * V/(2B)."""
    if p <= 1:
        return 0.0
    return alpha + (p - 1) / p * V / (2 * B)


def t_allreduce_hyperx_a2a(
    m: int, p: int, V: float, nB: float, alpha: float, k: float,
) -> float:
    """Eq. 13: all-to-all-based all-reduce on 2D-HyperX — latency does not
    grow with p.

    T = (m^2-1)/m^2 * V/(k nB)                  (local AR on mesh)
      + 2 [ T_AR(p, V/(2m^2), nB/m) + T_AR(mp... ) ]  -> assembled exact
      ~= 4 alpha + (2/k + 1/m) V / (2 nB)
    """
    local = (m * m - 1) / (m * m) * V / (k * nB)
    glob = 2 * (
        t_ar_a2a_phase(p, V / (2 * m * m), nB / m, alpha)
        + t_ar_a2a_phase(p, V / (2 * m * m * p), nB / m, alpha)
    )
    return local + glob


# ---------------------------------------------------------------------------
# High-dimensional all-reduce (Table 4's T_2D / T_3D over split dims)
# ---------------------------------------------------------------------------


def t_allreduce_hd(
    scales: Sequence[int], V: float, bandwidths: Sequence[float], alpha: float
) -> float:
    """T_hD(n_1..n_h): hierarchical all-reduce over h logical dimensions.

    Dimension i has ``scales[i]`` participants at per-chip bandwidth
    ``bandwidths[i]``.  Data is reduce-scattered dimension by dimension
    (shrinking V), all-reduced at the innermost level, then all-gathered
    back out — the standard BlueConnect/hierarchical decomposition the
    paper builds on [18]."""
    t = 0.0
    vol = V
    for s, bw in zip(scales, bandwidths):
        t += 2 * t_ring_phase(s, vol, bw, alpha)  # RS (+ matching AG later)
        vol /= max(s, 1)
    return t


# ---------------------------------------------------------------------------
# Hardware presets (evaluation §6.4) and TPU-v5e adaptation constants
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkConstants:
    """Bandwidths in GB/s, latencies in seconds."""

    ext_bw_per_port: float = 100.0        # paper §6.4: 100 GB/s per port
    int_bw_per_port: float = 400.0        # 4x internal
    alpha_ext: float = 300e-9             # 300 ns per external hop
    alpha_int: float = 10e-9              # 10 ns per internal hop


# TPU v5e single-chip constants used by the roofline (§Roofline).
TPU_V5E = {
    "peak_bf16_flops": 197e12,
    "hbm_bw": 819e9,
    "ici_bw_per_link": 50e9,
}


def paper_fig15_curves(
    sizes_bytes: Sequence[float],
    scales: Sequence[int],
    m: int = 2,
    n: int = 2,
    consts: LinkConstants = LinkConstants(),
    k: Optional[float] = None,
) -> Dict[str, Dict[int, Dict[float, float]]]:
    """Reproduce Figure 15's three algorithm curves.

    Per §6.4: each chip has four ports (n=2 per edge... the paper states
    "four ports per chip, double for the 1D-ring"), external 100 GB/s/port,
    internal 400 GB/s/port.  We report, for each algorithm, scale p and
    all-reduce size V: time in seconds.

    The per-fabric All-Reduce closed forms are resolved through the
    ``repro_torch.arch`` registry (``analytical.allreduce_time``): the
    ``torus_2d`` curve is the ``torus-2d`` architecture's form (Eq. 7)
    and ``hierarchical`` the ``railx-hyperx`` one (Eq. 8); the 1D-ring
    curve is fabric-independent (Eq. 6 over all chips, double bandwidth
    per the paper's note).
    """
    from ..arch import registry  # lazy: repro_torch.arch imports this module

    if k is None:
        k = consts.int_bw_per_port / consts.ext_bw_per_port
    B = consts.ext_bw_per_port * 1e9
    nB = n * B
    fabric_curves = {
        "torus_2d": registry["torus-2d"].analytical.allreduce_time,
        "hierarchical": registry["railx-hyperx"].analytical.allreduce_time,
    }
    out: Dict[str, Dict[int, Dict[float, float]]] = {
        "ring_1d": {}, **{name: {} for name in fabric_curves}
    }
    for p in scales:
        chips = m * m * p * p
        out["ring_1d"][p] = {}
        for name in fabric_curves:
            out[name][p] = {}
        for V in sizes_bytes:
            # 1D ring over all chips, double bandwidth (paper note)
            out["ring_1d"][p][V] = t_allreduce_ring(
                chips, V, 2 * nB, consts.alpha_ext
            )
            for name, form in fabric_curves.items():
                out[name][p][V] = form(
                    m, p, V, nB, consts.alpha_ext,
                    k=k, alpha_int=consts.alpha_int,
                )
    return out
