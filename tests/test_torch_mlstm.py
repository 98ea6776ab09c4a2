"""The port's chunkwise mLSTM (repro_torch.kernels.mlstm) against the JAX
package on the CPU: the plain versions against the sequential oracle, the
chunked jnp form (with its -1e30 input-gate padding) and the Pallas kernel
(interpret mode), the plain version of the CUDA kernels' order of sums
(chunk states in parallel, a serial combine, the outputs) likewise, and the
op's backward against jax.vjp of the sequential oracle.  The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.mlstm.ops import mlstm as jax_mlstm  # noqa: E402
from repro.kernels.mlstm.ref import mlstm_ref as jax_mlstm_ref  # noqa: E402
from repro.models.ssm import _mlstm_chunked  # noqa: E402
from repro_torch.kernels.mlstm import mlstm as mlstm_mod  # noqa: E402
from repro_torch.kernels.mlstm.ops import mlstm  # noqa: E402
from repro_torch.kernels.mlstm.ref import (  # noqa: E402
    mlstm_chunked_ref, mlstm_chunkstate_ref, mlstm_ref,
)

# jitted: compiled once per shape instead of run op by op (the Pallas kernel
# still runs in interpret mode)
jax_mlstm = jax.jit(jax_mlstm, static_argnums=5)
jax_mlstm_ref = jax.jit(jax_mlstm_ref)
_mlstm_chunked = jax.jit(_mlstm_chunked, static_argnums=5)

# the shapes of tests/test_kernels.py::test_mlstm_sweep, plus xlstm-125m's
# head dim D = 192 over two chunks
SHAPES = [(2, 128, 2, 32, 32), (1, 64, 3, 16, 64), (2, 256, 1, 64, 64), (1, 64, 1, 192, 32)]
# relative to the largest |h|: the reference test's own bound for the Pallas
# kernel against the sequential recurrence (f32, other summation orders,
# the stabiliser taken per chunk instead of per step)
REL = 1e-3
# f32 against f32 in the same (chunked) form: only the sum orders differ
SAME_FORM = 1e-5


def _inputs(B, S, H, D, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, H, D) / np.sqrt(D)).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    ig = rng.randn(B, S, H).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.randn(B, S, H) + 2, jnp.float32)))
    return q, k, v, ig, lf


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


@pytest.mark.parametrize("B,S,H,D,ch", SHAPES)
def test_plain_versions_match_jax_oracle_and_pallas(B, S, H, D, ch):
    arrs = _inputs(B, S, H, D)
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    oracle = np.asarray(jax_mlstm_ref(*j))
    pallas = np.asarray(jax_mlstm(*j, ch))                  # interpret mode on the CPU
    before = mlstm_mod.LAUNCHES
    got = mlstm_mod.mlstm_fwd(*t, chunk=ch)                 # CPU: the chunked plain version
    assert mlstm_mod.LAUNCHES == before                     # no kernel on the CPU
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    assert _rel(got.numpy(), oracle) < REL
    assert _rel(got.numpy(), pallas) < REL
    assert _rel(mlstm_ref(*t).numpy(), oracle) < SAME_FORM


@pytest.mark.parametrize("S,ch", [(128, 32), (100, 32), (37, 16)])
def test_chunked_ref_matches_jax_chunked_with_padding(S, ch):
    arrs = _inputs(2, S, 2, 16, seed=1)
    got = mlstm_chunked_ref(*[torch.from_numpy(a) for a in arrs], ch)
    want = _mlstm_chunked(*[jnp.asarray(a) for a in arrs], ch)
    assert got.shape == (2, S, 2, 16)
    assert _rel(got.numpy(), want) < SAME_FORM


def test_op_backward_matches_jax_vjp_of_the_oracle():
    arrs = _inputs(2, 24, 2, 8, seed=3)
    g = np.random.RandomState(4).randn(2, 24, 2, 8).astype(np.float32)
    _, vjp = jax.vjp(jax_mlstm_ref, *[jnp.asarray(a) for a in arrs])
    want = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y = mlstm(*t, chunk=8)
    got = torch.autograd.grad(y, t, torch.from_numpy(g))
    for a, b in zip(got, want):
        # f32 on both sides, the same recurrence differentiated
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_wrapper_chunk_rules():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 48, 1, 8)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        mlstm_mod.mlstm_fwd(*arrs, chunk=32)
    short = [a[:, :20] for a in arrs]  # chunk is cut to S, as in the reference
    np.testing.assert_allclose(mlstm_mod.mlstm_fwd(*short, chunk=64).numpy(),
                               mlstm_ref(*short).numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,D,ch", SHAPES)
def test_chunkstate_ref_matches_jax_oracle_and_pallas(B, S, H, D, ch):
    arrs = _inputs(B, S, H, D, seed=5)
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    got = mlstm_chunkstate_ref(*t, ch)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    assert _rel(got.numpy(), jax_mlstm_ref(*j)) < REL
    assert _rel(got.numpy(), jax_mlstm(*j, ch)) < REL      # interpret mode on the CPU
    assert _rel(got.numpy(), mlstm_chunked_ref(*t, ch).numpy()) < SAME_FORM


# an input gate of -1e30, the sentinel the model pads with, on: a whole
# chunk before any real row (where the plain form weighs the padding
# exp(-1e30 - (-1e30)) = 1), a chunk between real ones, scattered rows, every
# row; and S not a multiple of the chunk, padded inside
PAD_CASES = [("first_chunk", 128, 32, slice(0, 32)), ("middle_chunk", 128, 32, slice(64, 96)),
             ("scattered", 128, 32, slice(3, 128, 7)), ("every_row", 64, 32, slice(0, 64)),
             ("ragged", 100, 32, slice(0, 0)), ("ragged_tail", 37, 16, slice(30, 37))]


@pytest.mark.parametrize("name,S,ch,rows", PAD_CASES)
def test_chunkstate_ref_keeps_the_padding_sentinel(name, S, ch, rows):
    arrs = list(_inputs(2, S, 2, 16, seed=6))
    arrs[3][:, rows] = -1e30
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    got = mlstm_chunkstate_ref(*t, ch)
    assert got.shape == (2, S, 2, 16) and torch.isfinite(got).all()
    assert _rel(got.numpy(), _mlstm_chunked(*j, ch)) < SAME_FORM  # pads S itself
    assert _rel(got.numpy(), mlstm_chunked_ref(*t, ch).numpy()) < SAME_FORM
    assert _rel(got.numpy(), jax_mlstm_ref(*j)) < REL
    if S % ch == 0:  # the Pallas kernel takes whole chunks
        assert _rel(got.numpy(), jax_mlstm(*j, ch)) < REL


@pytest.mark.parametrize("ch", [128, 256])
def test_kernel_tiles_are_another_chunking(ch):
    """The CUDA kernels tile the rows by 64 whatever the caller's chunk: the
    chunked form at 64 is the Pallas kernel's function at chunks of 128 and
    256 (the range the wrapper takes), up to the order of the sums."""
    arrs = list(_inputs(1, 256, 2, 32, seed=7))
    arrs[3][:, 5::11] = -1e30
    t = [torch.from_numpy(a) for a in arrs]
    pallas = jax_mlstm(*[jnp.asarray(a) for a in arrs], ch)
    assert _rel(mlstm_chunkstate_ref(*t, 64).numpy(), pallas) < SAME_FORM
