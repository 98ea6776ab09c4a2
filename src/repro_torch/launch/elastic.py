"""Elastic restart planning (the port's own copy of ``repro/launch/elastic.py``
and of the two helpers it calls from ``repro/core/availability.py``; stdlib
only).

The production story:
  1. a node fails; its row or column leaves the single-job allocation;
  2. ``max_single_allocation`` (paper Algorithm 2) finds the largest healthy
     sub-grid;
  3. the launcher starts a new world over the surviving allocation and
     restores the latest checkpoint with resharding
     (``train.trainer.resume(..., layout=param_layout(zoo, mesh))``).

``plan_recovery`` implements steps 1-2 and emits the new mesh signature;
``examples/torch/fault_tolerant_training.py`` drives the whole drill.  The
semantics are the reference's, kept as they are: ``chips_per_node`` is taken
and not used, the mesh is ``(data, model)`` with ``data`` the healthy node
count, and an ``assert`` ties ``_best_rect`` to Algorithm 2.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Set, Tuple

Coord = Tuple[int, int]


def _classify(n: int, faults: Sequence[Coord]) -> Tuple[List[Coord], List[Coord]]:
    """Split faults into isolated (unique row AND column) and non-isolated
    (``repro/core/availability.py`` ``_classify``)."""
    rows: Dict[int, int] = {}
    cols: Dict[int, int] = {}
    for r, c in faults:
        rows[r] = rows.get(r, 0) + 1
        cols[c] = cols.get(c, 0) + 1
    isolated, clustered = [], []
    for r, c in faults:
        if rows[r] == 1 and cols[c] == 1:
            isolated.append((r, c))
        else:
            clustered.append((r, c))
    return isolated, clustered


def max_single_allocation(n: int, faults: Sequence[Coord]) -> int:
    """Algorithm 2: the largest single-job allocation (nodes) in an n x n grid
    with faulted nodes (``repro/core/availability.py``
    ``max_single_allocation``).

    Every fault must have its row or column disabled.  Isolated faults are
    interchangeable, so only the 2^|C| choices for the non-isolated faults
    are enumerated, and the |I| isolated faults are split between rows and
    columns to balance the remaining rectangle.
    """
    faults = list(dict.fromkeys(faults))
    if not faults:
        return n * n
    isolated, clustered = _classify(n, faults)
    if not clustered:
        ni = len(isolated)
        r = ni // 2
        c = ni - r
        return (n - max(r, c)) * (n - min(r, c))

    best = 0
    for choice in itertools.product((0, 1), repeat=len(clustered)):
        dis_rows: Set[int] = set()
        dis_cols: Set[int] = set()
        for (r, c), bit in zip(clustered, choice):
            if bit == 0:
                dis_rows.add(r)
            else:
                dis_cols.add(c)
        ri = len(dis_rows)
        ci = len(dis_cols)
        # isolated faults whose row or column is already disabled are free
        rem = [f for f in isolated if f[0] not in dis_rows and f[1] not in dis_cols]
        ni = len(rem)
        local_best = 0
        for rp in range(ni + 1):
            cp = ni - rp
            avail = max(0, n - ri - rp) * max(0, n - ci - cp)
            local_best = max(local_best, avail)
        best = max(best, local_best)
    return best


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    healthy_nodes: int
    grid_side_rows: int
    grid_side_cols: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    lost_fraction: float


def _best_rect(n: int, faults: Sequence[Coord]) -> Tuple[int, int]:
    """Rows x cols of the largest healthy allocation (the argmax of
    Algorithm 2, derived again)."""
    best = (0, 0)
    faults = list(dict.fromkeys(faults))
    if not faults:
        return (n, n)
    for bits in itertools.product((0, 1), repeat=len(faults)):
        rows = {f[0] for f, b in zip(faults, bits) if b == 0}
        cols = {f[1] for f, b in zip(faults, bits) if b == 1}
        r, c = n - len(rows), n - len(cols)
        if r * c > best[0] * best[1]:
            best = (r, c)
    return best


def plan_recovery(
    grid_side: int,
    failed_nodes: Sequence[Coord],
    chips_per_node: int = 16,
    model_axis: int = 16,
) -> RecoveryPlan:
    """Allocate the surviving sub-grid and emit a (data, model) mesh.

    The model axis (the node's 2D mesh of chips) is unaffected by node
    failures; the data axis shrinks to the node count of the largest healthy
    rectangle.
    """
    size = max_single_allocation(grid_side, list(failed_nodes))
    rows, cols = _best_rect(grid_side, failed_nodes)
    assert rows * cols == size, (rows, cols, size)
    data = rows * cols
    total = grid_side * grid_side
    return RecoveryPlan(
        healthy_nodes=size,
        grid_side_rows=rows,
        grid_side_cols=cols,
        mesh_shape=(data, model_axis),
        mesh_axes=("data", "model"),
        lost_fraction=1.0 - size / total,
    )
