"""The comparison that decides ``correct`` for a training cell.

Both sides give their readings of the first steps from the same weights and
batches: each step's loss, each weight's norm of the first gradient as
AdamW takes it (clipped), and each weight's norm of its change over the
steps (``reference.decoder_lm.train``'s keys).  The numbers compared:

* ``loss``: the largest |program - reference| of the steps' losses (nats);
* ``grad``: over the weights, the largest |norm_program - norm_reference|
  over the larger of the reference's norm of that weight and the median of
  the reference's norms;
* ``change``: the same for the change of the weights, leaving out each
  weight whose reference gradient is under a thousandth of the median
  weight's (nought to rounding: such a weight moves under AdamW by
  round-off alone).

A number with a limit in the cell's ``limits/<workload>.json`` is held to
it; the run is correct when there is such a number and every one is
finite and within its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Tuple

UNMOVED = 1e-3  # a weight whose reference gradient is under this x the median's


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    if set(prog) != set(ref):
        return math.inf  # the program's weights are not the reference's
    floor = statistics.median(ref[k] for k in leaves)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], floor) if max(ref[k], floor) > 0
            else abs(prog[k] - ref[k]) for k in leaves]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def numbers(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    if len(prog["loss"]) != len(ref["loss"]):
        return {"loss": math.inf, "grad": math.inf, "change": math.inf}
    gaps = [abs(a - b) for a, b in zip(prog["loss"], ref["loss"])]
    loss = max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf
    all_leaves = sorted(ref["grad"])
    median_grad = statistics.median(ref["grad"].values())
    moved = [k for k in all_leaves if ref["grad"][k] >= UNMOVED * median_grad]
    return {"loss": loss,
            "grad": _worst_leaf(prog["grad"], ref["grad"], all_leaves),
            "change": _worst_leaf(prog["change"], ref["change"], moved)}


def worst(prog: Dict[str, Any], ref: Dict[str, Any], n: int = 3) -> Dict[str, List]:
    """The ``n`` weights with the largest gaps of each per-weight number, as
    (weight, program's norm, reference's norm), for reading a cause."""
    out = {}
    for key in ("grad", "change"):
        floor = statistics.median(ref[key].values())
        gap = {k: abs(prog[key].get(k, math.inf) - r) / max(r, floor, 1e-30)
               for k, r in ref[key].items()}
        out[key] = [(k, prog[key].get(k), ref[key][k])
                    for k in sorted(gap, key=gap.get, reverse=True)[:n]]
    return out


def verdict(found: Dict[str, float], limits: Dict[str, Any]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {number: {"value", "limit"}}) over the numbers that have a
    limit."""
    checks = {k: {"value": found.get(k, math.inf), "limit": float(v["limit"])}
              for k, v in limits.items()}
    correct = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks
