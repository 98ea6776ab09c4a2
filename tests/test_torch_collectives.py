"""The port's collective schedules and int8 compression against the JAX
package, rank by rank.

The port runs in a gloo world of 8 local ranks (``torch_dist_worlds.py``),
JAX in its own process on 8 forced host devices; both take the same numpy
inputs, block r of each to rank r at mesh coordinate ``unravel(r, shape)``,
and write every rank's result to an ``.npz``.  The two processes run one
after the other, each with a time limit, so a hung collective fails the
tests instead of stalling the run (``torch_dist_worlds.run_in_turn``)."""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.collectives import compression as JC  # noqa: E402
from repro_torch.collectives import compression as TC  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RANKS = 8
# f32 sums over 8 ranks in another order: the reference's own tolerance
ATOL = 1e-4
# int8 values equal, so the dequantised sums differ by f32 rounding only
COMPRESSED_ATOL = 1e-5

sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402

JAX_SIDE = """
import sys
import numpy as np, jax, jax.numpy as jnp, re
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.collectives import schedules as S, compression as C
from repro.launch.mesh import make_mesh

workdir = sys.argv[1]
inp = np.load(workdir + "/inputs.npz")
out = {}

def per_rank(mesh, fn, blocks):
    axes = tuple(mesh.axis_names)
    n = blocks.shape[0]
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=P(axes), out_specs=P(axes), check_vma=False))
    res = f(jnp.asarray(blocks.reshape((-1,) + blocks.shape[2:])))
    return jax.tree_util.tree_map(
        lambda g: np.asarray(g).reshape((n, g.shape[0] // n) + g.shape[1:]), res)

mesh = make_mesh((4, 2), ("node", "mesh"))
cases = {
    "flat": lambda x: S.flat_all_reduce(x, ("node", "mesh")),
    "hierarchical": lambda x: S.hierarchical_all_reduce(x, "mesh", "node"),
    "ring2d": lambda x: S.ring_all_reduce_2d(x, ("mesh", "node")),
    "ring2d_yx": lambda x: S.ring_all_reduce_2d(x, ("node", "mesh")),
    "rs_dim0": lambda x: S.reduce_scatter_axis(x, ("node", "mesh"), 0),
    "rs_dim1": lambda x: S.reduce_scatter_axis(x, ("mesh", "node"), 1),
    "ag_dim0": lambda x: S.all_gather_axis(x, ("node", "mesh"), 0),
    "ag_dim1": lambda x: S.all_gather_axis(x, "mesh", 1),
    "hier_rs": lambda x: S.hierarchical_reduce_scatter(x, "mesh", "node", 0),
    "hier_rs_ag": lambda x: S.hierarchical_all_gather(
        S.hierarchical_reduce_scatter(x, "mesh", "node", 0), "mesh", "node", 0),
    "a2a_node": lambda x: S.all_to_all_axis(x, "node", 0, 1),
    "a2a_mesh": lambda x: S.all_to_all_axis(x, "mesh", 1, 0),
    "tree_hier": lambda x: S.tree_hierarchical_all_reduce(
        {"a": x[:5, :7], "b": x[0, :3]}, "mesh", "node"),
    "tree_flat": lambda x: S.tree_flat_all_reduce({"a": x[:5, :7], "b": x[0, :3]},
                                                  ("node", "mesh")),
}
for name, fn in cases.items():
    got = per_rank(mesh, fn, inp["x"])
    if isinstance(got, dict):
        out.update({f"{name}.{k}": v for k, v in got.items()})
    else:
        out[name] = got

# the reference's HLO all-reduce bytes on (2, 4), as tests/test_distributed.py reads them
mesh = make_mesh((2, 4), ("node", "mesh"))
sds = jax.ShapeDtypeStruct((16, 64), jnp.float32, sharding=NamedSharding(mesh, P("node", None)))
for sched in ("flat", "hierarchical"):
    fn = S.make_all_reduce_fn(mesh, P("node", None), sched, intra_axes="mesh", inter_axes="node")
    txt = fn.lower(sds).compile().as_text()
    total = 0
    for m in re.finditer(r"= \\S*?f32\\[([\\d,]*)\\][^\\n]*? all-reduce\\(", txt):
        total += 4 * int(np.prod([int(d) for d in m.group(1).split(",") if d]))
    out[f"hlo.{sched}"] = total

devs = np.array(jax.devices()[:4])
pod_data = Mesh(devs.reshape(2, 2), ("pod", "data"))
out["compressed"] = per_rank(
    pod_data, lambda y: C.compressed_hierarchical_all_reduce(y, ("data",), ("pod",)), inp["y"])
# the reference's compressed step without a pod axis: data as intra and inter
data4 = Mesh(devs, ("data",))
out["no_pod"] = per_rank(
    data4, lambda z: C.compressed_hierarchical_all_reduce(z, ("data",), ("data",)), inp["z"])
np.savez(workdir + "/jax.npz", **out)
"""


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(RANKS, 16, 24).astype(np.float32),     # (4, 2) cases
        "v": rng.randn(RANKS, 8, 64).astype(np.float32),      # (2, 4) byte ledger
        "y": rng.randn(4, 2 * (4096 + 1000)).astype(np.float32),  # (2, 2) pod x data
        "z": rng.randn(4, 16384).astype(np.float32),          # (4,) data, no pod
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the JAX process and the port's world one after the other;
    return (inputs, jax results, [port results by rank])."""
    work = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    worlds.run_in_turn(tmp_path_factory, {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work)],
        "port": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "collectives",
                 str(RANKS), str(work)],
    }, worlds.jax_env(SRC, RANKS))
    port = [dict(np.load(work / f"collectives_{r}.npz")) for r in range(RANKS)]
    return inputs, dict(np.load(work / "jax.npz")), port


CASES = ["flat", "hierarchical", "ring2d", "ring2d_yx", "rs_dim0", "rs_dim1", "ag_dim0",
         "ag_dim1", "hier_rs", "hier_rs_ag", "a2a_node", "a2a_mesh", "tree_hier", "tree_flat"]


@pytest.mark.parametrize("case", CASES)
def test_schedule_matches_jax_per_rank(runs, case):
    """Mirrors tests/test_distributed.py::test_collective_schedules_equivalence
    on the (4, 2) ("node", "mesh") mesh, every rank against its JAX device."""
    _, want, port = runs
    keys = [k for k in want if k == case or k.startswith(case + ".")]
    assert keys
    for key in keys:
        for r in range(RANKS):
            assert port[r][key].shape == want[key][r].shape, (key, r)
            np.testing.assert_allclose(port[r][key], want[key][r], atol=ATOL, rtol=0,
                                       err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("case", ["flat", "hierarchical", "ring2d", "hier_rs_ag", "tree_hier"])
def test_all_reduce_schedules_give_the_sum(runs, case):
    inputs, _, port = runs
    x = inputs["x"]
    want = x.sum(0) if case != "tree_hier" else x[:, :5, :7].sum(0)
    key = case if case != "tree_hier" else "tree_hier.a"
    for r in range(RANKS):
        np.testing.assert_allclose(port[r][key], want, atol=ATOL, rtol=0)


def test_hierarchical_reduces_inter_node_bytes(runs):
    """The Eq. 8 claim from the byte ledger on (2, 4) ("node", "mesh"),
    mirroring tests/test_distributed.py::test_hierarchical_reduces_inter_node_bytes:
    V = 2048 bytes a rank cross the node axis in the flat all-reduce, V/4 in
    the hierarchical one, whose intra reduce-scatter leaves V/4 a rank."""
    _, want, port = runs
    v = 8 * 64 * 4
    for r in range(RANKS):
        flat = sum(int(port[r][f"bytes.flat.{op}.node"])
                   for op in ("all_reduce", "reduce_scatter", "all_gather"))
        hier = sum(int(port[r][f"bytes.hierarchical.{op}.node"])
                   for op in ("all_reduce", "reduce_scatter", "all_gather"))
        assert hier * 3 < flat, (hier, flat)
        assert flat == v and hier == v // 4
        assert int(port[r]["bytes.hierarchical.reduce_scatter.mesh"]) == v // 4
        assert int(port[r]["bytes.hierarchical.all_gather.mesh"]) == v
    # the same all-reduce payloads as the reference's compiled HLO
    assert int(port[0]["bytes.flat.all_reduce.node"]) == int(want["hlo.flat"])
    assert int(port[0]["bytes.hierarchical.all_reduce.node"]) == int(want["hlo.hierarchical"])


def test_compressed_all_reduce_matches_jax_per_rank(runs):
    """(2, 2) ("pod", "data") in JAX; the port's (2, 2, 2) ("pod", "data",
    "model") ranks hold the same input along "model" and must agree."""
    inputs, want, port = runs
    for r in range(RANKS):
        np.testing.assert_allclose(port[r]["compressed"], want["compressed"][r // 2],
                                   atol=COMPRESSED_ATOL, rtol=0, err_msg=f"rank {r}")
    # int8 noise: within 1/127 of each chunk's max |.| per rank summed
    err = np.abs(port[0]["compressed"] - inputs["y"].sum(0)).max()
    assert 0 < err < 4 * np.abs(inputs["y"]).max() / 127


def test_compressed_refuses_overlapping_axes_and_the_reference_sum_is_wrong(runs):
    """The reference, with "data" as both intra and inter axes (its train
    step on a mesh without "pod"), adds different shards together; the port
    refuses those axes."""
    inputs, want, port = runs
    z = inputs["z"]
    err = max(np.abs(want["no_pod"][r] - z.sum(0)).max() for r in range(4))
    scale = np.abs(z.sum(0)).max()
    assert err > scale, (err, scale)  # 14.34 against a max |sum| of 7.98 on this input
    assert "overlap" in str(port[0]["refused"]) and "pod" in str(port[0]["refused"])


# ---------------------------------------------------------------------------
# the local halves of compression, in this process
# ---------------------------------------------------------------------------


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


COMPRESS = [((5000,), 4096, "float32"), ((3, 4096), 4096, "float32"), ((777,), 256, "float32"),
            ((2048,), 512, "bfloat16"), ((4096,), 4096, "zeros")]


@pytest.mark.parametrize("shape,chunk,kind", COMPRESS)
def test_int8_compress_matches_jax(shape, chunk, kind):
    rng = np.random.RandomState(hash((shape, chunk)) % 2 ** 31)
    x = np.zeros(shape, np.float32) if kind == "zeros" else rng.randn(*shape).astype(np.float32) * 3
    if kind == "bfloat16":
        jx, tx = _j(x).astype(jnp.bfloat16), _t(x).to(torch.bfloat16)
    else:
        jx, tx = _j(x), _t(x)
    want = JC.int8_compress(jx, chunk)
    got = TC.int8_compress(tx, chunk)
    assert got.values.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_max_ulp(got.scale.numpy(), np.asarray(want.scale), maxulp=1)
    back = TC.int8_decompress(got, tuple(shape), tx.dtype)
    wback = JC.int8_decompress(want, shape, jx.dtype)
    assert back.dtype == tx.dtype and tuple(back.shape) == tuple(shape)
    np.testing.assert_allclose(back.float().numpy(), np.asarray(wback, np.float32),
                               atol=COMPRESSED_ATOL, rtol=0)


def test_ef_compress_matches_jax_over_three_rounds():
    rng = np.random.RandomState(7)
    shape = (3000,)
    jef, tef = JC.ErrorFeedback.init(shape), TC.ErrorFeedback.init(shape)
    for i in range(3):
        g = rng.randn(*shape).astype(np.float32) * (i + 1)
        jc, jef = JC.ef_compress(_j(g), jef, 1024)
        tc, tef = TC.ef_compress(_t(g), tef, 1024)
        np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
        np.testing.assert_allclose(tef.residual.numpy(), np.asarray(jef.residual),
                                   atol=COMPRESSED_ATOL, rtol=0)
    assert np.abs(tef.residual.numpy()).max() > 0
