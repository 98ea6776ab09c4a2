"""The port's SSD scan (repro_torch.kernels.ssd) against the JAX package on
the CPU: the plain versions against the sequential oracle, the chunked jnp
form and the Pallas kernel (interpret mode), also across the Pallas
kernel's documented range and at the CUDA kernel's own tiling, and the op's
backward against jax.vjp of the sequential oracle.  The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd.ops import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models.ssm import _ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref  # noqa: E402

# jitted: compiled once per shape instead of run op by op (the Pallas kernel
# still runs in interpret mode)
jax_ssd = jax.jit(jax_ssd, static_argnums=5)
jax_ssd_ref = jax.jit(jax_ssd_ref)
_ssd_chunked = jax.jit(_ssd_chunked, static_argnums=5)

# the shapes of tests/test_kernels.py::test_ssd_sweep
SHAPES = [(2, 128, 3, 32, 16, 32), (1, 64, 2, 64, 64, 64), (2, 256, 1, 16, 8, 64)]
# relative to the largest |y|: the reference test's own bound for the Pallas
# kernel against the sequential scan (f32, other summation orders)
REL = 1e-4
# f32 against f32 in the same (chunked) form: only XLA's and torch's sum
# orders differ
SAME_FORM = 1e-5


def _inputs(B, S, H, P, N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, P).astype(np.float32),
            (np.abs(rng.randn(B, S, H)) * 0.1 + 0.01).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32),
            (-(np.abs(rng.randn(H)) + 0.5)).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


@pytest.mark.parametrize("B,S,H,P,N,ch", SHAPES)
def test_plain_versions_match_jax_oracle_and_pallas(B, S, H, P, N, ch):
    arrs = _inputs(B, S, H, P, N)
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    oracle = np.asarray(jax_ssd_ref(*j))
    pallas = np.asarray(jax_ssd(*j, ch))                    # interpret mode on the CPU
    before = ssd_mod.LAUNCHES
    got = ssd_mod.ssd_fwd(*t, chunk=ch)                     # CPU: the chunked plain version
    assert ssd_mod.LAUNCHES == before                       # no kernel on the CPU
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    assert _rel(got.numpy(), oracle) < REL
    assert _rel(got.numpy(), pallas) < REL
    assert _rel(ssd_ref(*t).numpy(), oracle) < SAME_FORM


@pytest.mark.parametrize("B,S,H,P,N,ch", SHAPES)
def test_chunked_ref_matches_jax_chunked_with_state(B, S, H, P, N, ch):
    arrs = _inputs(B, S, H, P, N, seed=1)
    y, st = ssd_chunked_ref(*[torch.from_numpy(a) for a in arrs], ch)
    jy, jst = _ssd_chunked(*[jnp.asarray(a) for a in arrs], ch)
    assert _rel(y.numpy(), jy) < SAME_FORM
    assert _rel(st.numpy(), jst) < SAME_FORM


def test_op_backward_matches_jax_vjp_of_the_oracle():
    B, S, H, P, N = 2, 24, 2, 8, 4
    arrs = _inputs(B, S, H, P, N, seed=3)
    g = np.random.RandomState(4).randn(B, S, H, P).astype(np.float32)
    _, vjp = jax.vjp(jax_ssd_ref, *[jnp.asarray(a) for a in arrs])
    want = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y = ssd(*t, chunk=8)
    got = torch.autograd.grad(y, t, torch.from_numpy(g))
    for a, b in zip(got, want):
        # f32 on both sides, the same recurrence differentiated
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_wrapper_chunk_rules():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 48, 1, 4, 4)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_mod.ssd_fwd(*arrs, chunk=32)
    # chunk is cut to S, as in the reference
    short = [a[:, :20] if a.dim() > 1 else a for a in arrs]
    np.testing.assert_allclose(ssd_mod.ssd_fwd(*short, chunk=64).numpy(),
                               ssd_ref(*short).numpy(), atol=1e-5, rtol=1e-5)


# the Pallas kernel's documented range (chunks of 64-256 rows, P and N up to
# 128), which the CUDA kernel takes too, at a small B H S
WIDE = [(1, 256, 2, 128, 128, 128), (1, 512, 1, 32, 16, 256), (1, 512, 1, 128, 128, 256)]


@pytest.mark.parametrize("B,S,H,P,N,ch", WIDE)
def test_widened_shapes_match_pallas_and_the_oracle(B, S, H, P, N, ch):
    arrs = _inputs(B, S, H, P, N, seed=5)
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    got = ssd_mod.ssd_fwd(*t, chunk=ch)                     # CPU: the chunked plain version
    assert got.shape == (B, S, H, P)
    assert _rel(got.numpy(), jax_ssd(*j, ch)) < REL         # interpret mode on the CPU
    assert _rel(got.numpy(), jax_ssd_ref(*j)) < REL


@pytest.mark.parametrize("ch", [64, 128, 256])
def test_kernel_tiles_are_another_chunking(ch):
    """The CUDA kernel walks tiles of 32 rows whatever the caller's chunk:
    the chunked form at 32 is the Pallas kernel's function at chunks of 64
    to 256, up to the order of the sums."""
    arrs = _inputs(1, 256, 2, 32, 16, seed=6)
    pallas = jax_ssd(*[jnp.asarray(a) for a in arrs], ch)
    got = ssd_chunked_ref(*[torch.from_numpy(a) for a in arrs], 32)[0]
    assert _rel(got.numpy(), pallas) < REL
