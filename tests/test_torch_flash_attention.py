"""Port flash attention on the CPU: its plain version (attention_ref) and
the wrapper against the JAX oracle and the JAX Pallas kernel in interpret
mode, on the same numpy inputs."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.flash_attention import flash_attention_fwd as jax_flash_fwd  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# tests/test_kernels.py sweep shapes, plus a q_offset case (Sq < Skv)
CASES = [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset, dtype
    (2, 4, 2, 256, 256, 64, True, None, 0, "float32"),
    (1, 2, 1, 128, 128, 128, True, 64, 0, "float32"),
    (2, 2, 2, 256, 256, 32, False, None, 0, "float32"),
    (1, 8, 4, 512, 512, 64, True, 128, 0, "float32"),
    (2, 4, 4, 256, 256, 64, True, None, 0, "bfloat16"),
    (1, 4, 2, 128, 256, 64, True, None, 128, "float32"),
]
# the JAX kernel tests' tolerances: f32 2e-5, bf16 2e-2 (output rounding)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, seed=0):
    B, H, Hk, Sq, Skv, Dh, *_ , dtype = case
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, Sq, Dh), rng.randn(B, Hk, Skv, Dh), rng.randn(B, Hk, Skv, Dh)]
    # round once to the working dtype so both sides see identical values
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype)) for a in jx]
    return jx, tx


def _kw(case):
    *_, causal, window, q_offset, _dtype = case
    return dict(causal=causal, window=window, q_offset=q_offset)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("case", CASES)
def test_attention_ref_matches_jax_ref(case):
    jx, tx = _inputs(case)
    _close(attention_ref(*tx, **_kw(case)), jax_ref(*jx, **_kw(case)), case[-1])


@pytest.mark.parametrize("case", CASES)
def test_attention_ref_matches_jax_flash_interpret(case):
    jx, tx = _inputs(case, seed=1)
    _close(attention_ref(*tx, **_kw(case)), jax_flash_fwd(*jx, **_kw(case)), case[-1])


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    case = CASES[3]
    _, tx = _inputs(case)
    before = fa.LAUNCHES
    out = fa.flash_attention_fwd(*tx, **_kw(case))
    assert torch.equal(out, attention_ref(*tx, **_kw(case)))
    assert fa.LAUNCHES == before


def test_model_layout_matches_jax_ops():
    rng = np.random.RandomState(2)
    q, k, v = rng.randn(2, 64, 4, 32), rng.randn(2, 64, 2, 32), rng.randn(2, 64, 2, 32)
    want = jax_flash(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    got = flash_attention(*(torch.from_numpy(a).float() for a in (q, k, v)))
    assert got.shape == (2, 64, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_row_that_sees_no_key_averages_v_as_jax():
    # window without causal: rows at q >= 143 see no key among 128
    case = (1, 4, 2, 64, 128, 64, False, 16, 100, "float32")
    jx, tx = _inputs(case, seed=3)
    got = attention_ref(*tx, **_kw(case))
    _close(got, jax_ref(*jx, **_kw(case)), "float32")
    mean_v = tx[2].mean(dim=2)  # (B, Hk, Dh)
    np.testing.assert_allclose(got[0, 0, -1].numpy(), mean_v[0, 0].numpy(), atol=1e-5)


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q[:, :1], q[:, :1])
