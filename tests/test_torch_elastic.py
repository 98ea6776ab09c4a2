"""The port's elastic planning (``repro_torch/launch/elastic.py``) against the
reference's ``plan_recovery``, ``_best_rect`` and Algorithm 2
(``max_single_allocation``, ``_classify``): on the reference's own cases
(``tests/test_elastic.py``), on fault sets planted from numpy seed 0, and on
the fault drill's faults."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import availability as jax_avail  # noqa: E402
from repro.launch import elastic as ref  # noqa: E402
from repro_torch.launch import elastic as port  # noqa: E402

# the reference's own cases: (grid_side, failed nodes, model_axis)
REFERENCE_CASES = [
    (16, [], 16),
    (16, [(3, 7)], 16),
    (8, [(0, 0), (1, 1), (2, 2), (3, 3)], 4),
    (8, [(2, 1), (2, 5)], 4),
]


def _planted(count=40, seed=0):
    """Grids of side 2-6 with 0-5 faults (repeats and shared rows or columns
    included) and a model axis, from numpy seed 0."""
    rng = np.random.RandomState(seed)
    cases = []
    for _ in range(count):
        n = int(rng.randint(2, 7))
        faults = [(int(rng.randint(n)), int(rng.randint(n))) for _ in range(rng.randint(0, 6))]
        cases.append((n, faults, int(rng.choice([1, 2, 4, 16]))))
    return cases


def _outcome(fn, *args, **kwargs):
    """A call's result, or its exception's type and message."""
    try:
        return "ok", fn(*args, **kwargs)
    except Exception as e:  # both packages must raise alike
        return type(e).__name__, str(e)


def _as_tuple(plan):
    return dataclasses.astuple(plan) if dataclasses.is_dataclass(plan) else plan


@pytest.mark.parametrize("n,faults,model_axis", REFERENCE_CASES + _planted(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_plan_recovery_matches_the_reference(n, faults, model_axis):
    """Every field of the plan equal (or both raise alike), and so are
    Algorithm 2's size, the fault classes and the best rectangle."""
    got_kind, got = _outcome(port.plan_recovery, n, faults, chips_per_node=2,
                             model_axis=model_axis)
    want_kind, want = _outcome(ref.plan_recovery, n, faults, chips_per_node=2,
                               model_axis=model_axis)
    assert got_kind == want_kind
    assert _as_tuple(got) == _as_tuple(want)
    assert [f.name for f in dataclasses.fields(port.RecoveryPlan)] == \
        [f.name for f in dataclasses.fields(ref.RecoveryPlan)]
    assert port.max_single_allocation(n, faults) == jax_avail.max_single_allocation(n, faults)
    assert port._best_rect(n, faults) == ref._best_rect(n, faults)
    uniq = list(dict.fromkeys(faults))
    assert port._classify(n, uniq) == jax_avail._classify(n, uniq)


def test_the_reference_cases_hold_in_the_port():
    """``tests/test_elastic.py``'s expectations, on the port's plan."""
    p = port.plan_recovery(16, [], model_axis=16)
    assert (p.healthy_nodes, p.mesh_shape, p.lost_fraction) == (256, (256, 16), 0.0)
    p = port.plan_recovery(16, [(3, 7)], model_axis=16)
    assert p.healthy_nodes == 240 == p.grid_side_rows * p.grid_side_cols
    assert p.lost_fraction == pytest.approx(1 - 240 / 256)
    p = port.plan_recovery(8, [(0, 0), (1, 1), (2, 2), (3, 3)], model_axis=4)
    assert (p.healthy_nodes, p.mesh_shape) == (36, (36, 4))
    assert port.plan_recovery(8, [(2, 1), (2, 5)], model_axis=4).healthy_nodes == 56


def test_the_drill_plan_is_not_the_drill_mesh():
    """The drill's faults give a 3 x 3 healthy grid and a (9, 2) mesh, in both
    packages; the drill then rebuilds on a hard-coded (2, 2) mesh (a quirk of
    the reference that the twin mirrors), and ``chips_per_node`` changes
    nothing."""
    faults = [(0, 1), (2, 3)]
    for chips in (2, 16):
        p = port.plan_recovery(grid_side=4, failed_nodes=faults, chips_per_node=chips,
                               model_axis=2)
        assert dataclasses.astuple(p) == dataclasses.astuple(ref.plan_recovery(
            grid_side=4, failed_nodes=faults, chips_per_node=chips, model_axis=2))
        assert (p.grid_side_rows, p.grid_side_cols, p.mesh_shape) == (3, 3, (9, 2))
        assert p.mesh_axes == ("data", "model")
        assert p.lost_fraction == pytest.approx(7 / 16)
