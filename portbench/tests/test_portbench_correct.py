"""What decides ``correct``: the plain reference follows repro_torch's train
step on the registry's smoke models; a run with its timed path broken, and
the fp8 control in the program's place, come out not correct."""

from __future__ import annotations

import pytest
import torch

from portbench_cells import TINY_LIMITS, cell

from portbench import bench, compare

TRAIN = bench.runner("train")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("registry,shared", [("moonshot-v1-16b-a3b", 0), ("moonshot-v1-16b-a3b", 2),
                                             ("qwen3-8b", 0)])
def test_the_reference_follows_the_ports_step_in_float32(registry, shared):
    c = cell(registry, "float32", shared_experts=shared)
    prog = TRAIN.build(c, 2 ** 31 + 3, "cpu")
    found = TRAIN.checked_steps(prog, 3)
    ref = TRAIN.reference_readings(c, 2 ** 31 + 3, "cpu", 3)
    nums = compare.numbers(found, ref)
    assert nums["loss"] < 2e-5 and nums["grad"] < 2e-5 and nums["change"] < 2e-5, nums
    assert ref["loss"][2] < ref["loss"][0]  # the three steps train


@pytest.mark.parametrize("registry", ["moonshot-v1-16b-a3b", "qwen3-8b"])
def test_a_bf16_run_is_correct_within_the_tiny_limits(registry):
    out = TRAIN.run(cell(registry, "bfloat16"), 11, 0.1, False, 0.0, device="cpu")
    assert out["correct"], out["numbers"]
    assert set(out["checks"]) == set(TINY_LIMITS)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    out = TRAIN.run(cell("moonshot-v1-16b-a3b", "bfloat16"), 12, 0.1, False, 0.0, device="cpu",
                    fault=fault)
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("seed", [3, 12, 13])
def test_the_fp8_control_is_not_correct(seed):
    c = cell("moonshot-v1-16b-a3b", "bfloat16")
    ref = TRAIN.reference_readings(c, seed, "cpu", 3)
    control = TRAIN.reference_readings(c, seed, "cpu", 3, "fp8")
    correct, checks = compare.verdict(compare.numbers(control, ref), c.limits)
    assert not correct, checks


def test_no_limit_is_no_verdict():
    assert compare.verdict({"loss": 0.0}, {}) == (False, {})
    correct, checks = compare.verdict({"loss": float("nan")}, {"loss": {"limit": 1.0}})
    assert not correct
