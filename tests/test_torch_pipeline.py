"""``repro_torch.parallel.pipeline`` (GPipe over a "pipe" ring of
``isend`` / ``irecv``) against the reference's ``make_pipelined_apply``:
tests/test_distributed.py's case (4 stages, each multiplying by its stage
weight, 6 microbatches) on a gloo world of 4 (``torch_dist_worlds.pipeline``)
and in a JAX process on 4 forced host devices, from the same numpy inputs;
and a one-stage ring, whose hop is a local copy."""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402

STAGES, MICRO = 4, 6

JAX_SIDE = """
import sys
import numpy as np, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.parallel.pipeline import make_pipelined_apply

inp = np.load(sys.argv[1] + "/inputs.npz")
fn = make_pipelined_apply(make_mesh((4,), ("pipe",)), lambda w, x: x @ w, num_micro=6,
                          axis="pipe")
np.savez(sys.argv[1] + "/jax.npz", out=np.asarray(fn(jnp.asarray(inp["ws"]),
                                                      jnp.asarray(inp["xs"]))))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    ws = np.stack([np.eye(8, dtype=np.float32) * (i + 1) for i in range(STAGES)])
    xs = np.random.RandomState(0).randn(MICRO, 3, 8).astype(np.float32)
    np.savez(work / "inputs.npz", ws=ws, xs=xs)
    worlds.run_in_turn(tmp_path_factory, {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work)],
        "pipeline": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "pipeline",
                     str(STAGES), str(work)],
    }, worlds.jax_env(SRC, STAGES))
    return {"ws": ws, "xs": xs, "jax": np.load(work / "jax.npz")["out"],
            "port": [dict(np.load(work / f"pipeline_{r}.npz")) for r in range(STAGES)]}


def test_four_stage_pipeline_matches_the_references_test(runs):
    """tests/test_distributed.py::test_pipeline_parallel_forward: x * 1 * 2
    * 3 * 4 within 1e-4, on every rank (the last stage's outputs broadcast)."""
    want = runs["xs"] * 1 * 2 * 3 * 4
    for port in runs["port"]:
        assert np.abs(port["four"] - want).max() < 1e-4


def test_four_stage_pipeline_matches_jax(runs):
    """The reference's make_pipelined_apply on the same numpy inputs."""
    for port in runs["port"]:
        np.testing.assert_allclose(port["four"], runs["jax"], rtol=1e-6, atol=1e-6)


def test_one_stage_pipeline_is_its_stage(runs):
    """A ring of one stage (each rank of a (4, 1) "rep", "pipe" mesh): the
    hop is a local copy and the outputs are the stage function's."""
    for r, port in enumerate(runs["port"]):
        np.testing.assert_array_equal(port["one"], runs["xs"] @ runs["ws"][r])
