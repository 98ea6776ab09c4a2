"""The port's training kernels on the CPU (their plain versions) against the
JAX package: ``flash_attention_fwd_lse`` and ``flash_attention_bwd`` against
the Pallas kernels in interpret mode, the rows that see no key against
``jax.grad`` of the JAX oracle (where the Pallas backward departs), and the
autograd Function against ``jax.grad`` of the JAX ``custom_vjp``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jfa  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

# every row of these sees at least one key (the Pallas kernels' blocks of
# 128 need Sq and Skv to be multiples of min(128, S))
CASES = [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset, dtype
    (2, 4, 2, 128, 128, 64, True, None, 0, "float32"),
    (1, 4, 2, 128, 256, 32, True, None, 128, "float32"),       # q_offset
    (1, 2, 1, 256, 256, 64, True, 64, 0, "float32"),           # window, MQA
    (2, 2, 2, 128, 128, 32, False, None, 0, "float32"),        # non-causal
    (1, 4, 4, 128, 128, 128, True, None, 0, "float32"),
    (1, 4, 2, 128, 128, 64, True, None, 0, "bfloat16"),
    # head_dim 320 (gemma3-4b's 2560 / 8), windowed and not
    (1, 2, 1, 256, 256, 320, True, None, 0, "float32"),
    (1, 2, 1, 256, 256, 320, True, 64, 0, "float32"),
    (1, 4, 2, 128, 128, 320, True, None, 0, "bfloat16"),
    (1, 4, 2, 128, 128, 320, True, 64, 0, "bfloat16"),
]
# a rank's geometry under sequence parallelism over 4: its Sq = S / 4 queries
# from q_offset = r S / 4 over all S keys, so the keys past its last query
# (every rank's but the last) take no gradient; the first, a middle and the
# last rank, gemma3's window and head dim, and bf16
SP_CASES = [
    (1, 4, 2, 128, 512, 64, True, None, 0, "float32"),
    (1, 4, 2, 128, 512, 64, True, None, 256, "float32"),
    (1, 4, 2, 128, 512, 64, True, None, 384, "float32"),
    (1, 2, 1, 128, 512, 320, True, 64, 128, "float32"),
    (1, 4, 2, 128, 512, 128, True, None, 128, "bfloat16"),
]
# f32: both sides f32, sums in another order (dk/dv sum up to Sq x group
# terms); bf16: both round the outputs to bf16, one ulp at |x| in [2, 4) is
# 2^-6, so 2e-2 of the output's scale
TOL = {"float32": 5e-5, "bfloat16": 2e-2}


def _inputs(case, seed=0):
    B, H, Hk, Sq, Skv, Dh, *_, dtype = case
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, Sq, Dh), rng.randn(B, Hk, Skv, Dh), rng.randn(B, Hk, Skv, Dh),
            rng.randn(B, H, Sq, Dh)]
    # round once to the working dtype so both sides see identical values
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype)) for a in jx]
    return jx, tx


def _kw(case):
    *_, causal, window, q_offset, _dtype = case
    return dict(causal=causal, window=window, q_offset=q_offset)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype] * scale, rtol=0)


@pytest.mark.parametrize("case", CASES + SP_CASES)
def test_fwd_lse_matches_jax_pallas_interpret(case):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(case)
    jo, jlse = jfa.flash_attention_fwd_lse(jq, jk, jv, **_kw(case), interpret=True)
    before = fa.LSE_LAUNCHES
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **_kw(case))
    assert fa.LSE_LAUNCHES == before  # the CPU takes the plain version
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    _close(o, jo, case[-1])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", CASES + SP_CASES)
def test_bwd_matches_jax_pallas_interpret(case):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(case, seed=1)
    jo, jlse = jfa.flash_attention_fwd_lse(jq, jk, jv, **_kw(case), interpret=True)
    want = jfa.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, **_kw(case), interpret=True)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **_kw(case))
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **_kw(case))
    for g, w, like in zip(got, want, (q, k, v)):
        assert g.dtype == like.dtype and g.shape == like.shape
        _close(g, w, case[-1])


@pytest.mark.parametrize("case", SP_CASES)
def test_keys_past_the_last_query_take_no_gradient(case):
    """At a sequence-parallel rank's geometry dK and dV are exactly 0 on
    the keys past its last query, and nonzero on some key before it."""
    _, (q, k, v, do) = _inputs(case, seed=3)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **_kw(case))
    _, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **_kw(case))
    end = case[3] + case[8]  # Sq + q_offset
    for g in (dk, dv):
        assert torch.all(g[:, :, end:] == 0)
        assert torch.any(g[:, :, :end] != 0)


# window without causal: query rows at q >= 143 see no key among 128
NO_KEY = (1, 4, 2, 64, 128, 64, False, 16, 100, "float32")


def _jax_grads(jq, jk, jv, jdo, kw):
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, **kw), jq, jk, jv)
    return vjp(jdo)


def test_rows_that_see_no_key_match_jax_grad_of_the_oracle():
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(NO_KEY, seed=2)
    kw = _kw(NO_KEY)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    # lse of a row that sees no key: the logsumexp of its scores taken as 0
    np.testing.assert_allclose(lse[0, :, -1].numpy(), np.log(128.0), rtol=1e-6)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = _jax_grads(jq, jk, jv, jdo, kw)
    for g, w in zip(got, want):
        _close(g, w, "float32")
    # such a row takes no gradient into q, and adds do / Skv to every dv row
    assert torch.all(got[0][0, :, -1] == 0)


def test_the_pallas_backward_departs_on_rows_that_see_no_key():
    """The reference quirk the port does not copy: the Pallas kernel stores
    lse = -1e30 + log(Skv), which rounds to -1e30, so its backward takes
    P = 1 instead of 1/Skv on those rows."""
    jx, _ = _inputs(NO_KEY, seed=2)
    jq, jk, jv, jdo = jx
    kw = _kw(NO_KEY)
    jo, jlse = jfa.flash_attention_fwd_lse(jq, jk, jv, **kw, interpret=True)
    assert float(jlse[0, 0, -1]) == float(np.float32(-1e30))
    pallas = jfa.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, **kw, interpret=True)
    want = _jax_grads(jq, jk, jv, jdo, kw)
    assert max(float(jnp.abs(a - b).max()) for a, b in zip(pallas, want)) > 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_jax_grad_of_the_custom_vjp(causal):
    rng = np.random.RandomState(3)
    arrs = [rng.randn(2, 128, 4, 32), rng.randn(2, 128, 2, 32), rng.randn(2, 128, 2, 32)]
    cot = rng.randn(2, 128, 4, 32)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal),
                       *(jnp.asarray(a, jnp.float32) for a in arrs))
    want = vjp(jnp.asarray(cot, jnp.float32))
    q, k, v = (torch.from_numpy(a).float().requires_grad_() for a in arrs)
    got_out = flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), atol=2e-5)
    got = torch.autograd.grad(got_out, (q, k, v), torch.from_numpy(cot).float())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_no_grad_takes_the_forward_without_lse():
    q, k, v = (torch.randn(1, 64, h, 16, requires_grad=True) for h in (2, 1, 1))
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None
    assert flash_attention(q, k, v).grad_fn is not None
