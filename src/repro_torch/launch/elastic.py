"""Elastic restart planning (the port's own copy of ``repro/launch/elastic.py``;
stdlib only).  Algorithm 2 and its fault classifier come from the port's
``core/availability.py``.

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
from typing import Sequence, Tuple

from ..core.availability import _classify, max_single_allocation  # noqa: F401

Coord = Tuple[int, int]


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
