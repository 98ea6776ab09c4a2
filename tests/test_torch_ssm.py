"""The port's recurrent blocks (repro_torch.models.ssm: Mamba2, mLSTM,
sLSTM) against repro.models.ssm on the CPU, full-sequence form and state
step, with the JAX weights carried over by params_from_jax."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as J  # noqa: E402
from repro.models.common import DTypes as JDTypes  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import ssm as T  # noqa: E402
from repro_torch.models.common import DTypes, ParamTree  # noqa: E402

# f32 on both sides: XLA and torch differ in sum order and libm only; 1e-4
# is test_model_ssm_equivalences' own bound (tests/test_kernels.py)
F32 = dict(atol=1e-4, rtol=1e-4)
MCFG = dict(d_model=32, d_state=16, head_dim=16, expand=2, chunk=8)
XCFG = dict(d_model=32, heads=4, chunk=8)
# the reference blocks, jitted: compiled once per shape instead of run op by op
J_MAMBA2, J_MLSTM, J_SLSTM = (jax.jit(f, static_argnums=(1, 3)) for f in (J.mamba2, J.mlstm, J.slstm))


def _carry(jparams):
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32", device="cpu")
    return ParamTree.from_state_dict(sd)


def _x(S, seed=1, B=2, D=32):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("S", [24, 20, 5])  # whole chunks, a padded tail, one short chunk
def test_mamba2_full_sequence_matches_jax(S):
    jc, tc = J.Mamba2Config(**MCFG), T.Mamba2Config(**MCFG)
    jp = J.init_mamba2(jax.random.PRNGKey(0), jc, JDTypes())
    x = _x(S)
    want, _ = J_MAMBA2(jp, jc, jnp.asarray(x), JDTypes())
    got, st = T.mamba2(_carry(jp), tc, _t(x), DTypes())
    assert st is None
    _close(got, want)


def test_mamba2_state_steps_match_jax():
    jc, tc = J.Mamba2Config(**MCFG), T.Mamba2Config(**MCFG)
    jp = J.init_mamba2(jax.random.PRNGKey(0), jc, JDTypes())
    tp = _carry(jp)
    x = _x(6, seed=2)
    jst = J.mamba2_init_state(jc, 2)
    tst = T.mamba2_init_state(tc, 2, torch.float32, "cpu")
    for t in range(6):
        want, jst = J_MAMBA2(jp, jc, jnp.asarray(x[:, t:t + 1]), JDTypes(), state=jst)
        got, tst = T.mamba2(tp, tc, _t(x[:, t:t + 1]), DTypes(), state=tst)
        _close(got, want)
    _close(tst["conv"], jst["conv"])
    _close(tst["ssm"], jst["ssm"])
    with pytest.raises(ValueError, match="one token"):
        T.mamba2(tp, tc, _t(x[:, :2]), DTypes(), state=tst)


def test_mamba2_chunked_prefill_equals_its_recurrence():
    """The reference's own check (test_model_ssm_equivalences), on the port."""
    tc = T.Mamba2Config(**MCFG)
    tp = _carry(J.init_mamba2(jax.random.PRNGKey(0), J.Mamba2Config(**MCFG), JDTypes()))
    x = _t(_x(24, seed=3))
    y_par, _ = T.mamba2(tp, tc, x, DTypes())
    st, ys = T.mamba2_init_state(tc, 2, torch.float32, "cpu"), []
    for t in range(24):
        yt, st = T.mamba2(tp, tc, x[:, t:t + 1], DTypes(), state=st)
        ys.append(yt)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), atol=1e-4)


@pytest.mark.parametrize("S", [24, 20])
def test_mlstm_full_sequence_matches_jax(S):
    jc, tc = J.XLSTMConfig(**XCFG), T.XLSTMConfig(**XCFG)
    jp = J.init_mlstm(jax.random.PRNGKey(2), jc, JDTypes())
    x = _x(S)
    want, _ = J_MLSTM(jp, jc, jnp.asarray(x), JDTypes())
    got, _ = T.mlstm(_carry(jp), tc, _t(x), DTypes())
    _close(got, want)


def test_mlstm_state_steps_match_jax():
    """A 3-token step from the zero state, then single steps: output and
    state (the decode normaliser max(|q.n|, 1))."""
    jc, tc = J.XLSTMConfig(**XCFG), T.XLSTMConfig(**XCFG)
    jp = J.init_mlstm(jax.random.PRNGKey(2), jc, JDTypes())
    tp = _carry(jp)
    x = _x(5, seed=4)
    jst, tst = J.mlstm_init_state(jc, 2), T.mlstm_init_state(tc, 2, "cpu")
    for lo, hi in [(0, 3), (3, 4), (4, 5)]:
        want, jst = J_MLSTM(jp, jc, jnp.asarray(x[:, lo:hi]), JDTypes(), state=jst)
        got, tst = T.mlstm(tp, tc, _t(x[:, lo:hi]), DTypes(), state=tst)
        _close(got, want)
    for k in ("C", "n", "m"):
        _close(tst[k], jst[k])


def test_slstm_matches_jax():
    jc, tc = J.XLSTMConfig(**XCFG), T.XLSTMConfig(**XCFG)
    jp = J.init_slstm(jax.random.PRNGKey(3), jc, JDTypes())
    tp = _carry(jp)
    x = _x(7, seed=5)
    want, _ = J_SLSTM(jp, jc, jnp.asarray(x), JDTypes())
    got, st = T.slstm(tp, tc, _t(x), DTypes())
    assert st is None
    _close(got, want)
    jst, tst = J.slstm_init_state(jc, 2), T.slstm_init_state(tc, 2, "cpu")
    for lo, hi in [(0, 4), (4, 5)]:
        want, jst = J_SLSTM(jp, jc, jnp.asarray(x[:, lo:hi]), JDTypes(), state=jst)
        got, tst = T.slstm(tp, tc, _t(x[:, lo:hi]), DTypes(), state=tst)
        _close(got, want)
    for k in ("c", "n", "m"):
        _close(tst[k], jst[k])


def test_block_param_trees_match_jax():
    gen = torch.Generator().manual_seed(0)
    for jinit, tinit, jcfg, tcfg in (
            (J.init_mamba2, T.init_mamba2, J.Mamba2Config(**MCFG), T.Mamba2Config(**MCFG)),
            (J.init_mlstm, T.init_mlstm, J.XLSTMConfig(**XCFG), T.XLSTMConfig(**XCFG)),
            (J.init_slstm, T.init_slstm, J.XLSTMConfig(**XCFG), T.XLSTMConfig(**XCFG))):
        jp = _carry(jinit(jax.random.PRNGKey(0), jcfg, JDTypes())).state_dict()
        tp = ParamTree(tinit(gen, tcfg, DTypes(), "cpu")).state_dict()
        assert {k: v.shape for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
        for k in ("A_log", "D", "dt_bias", "conv_b"):  # deterministic inits
            if k in jp:
                _close(tp[k], jp[k].numpy())


def test_block_specs_match_jax():
    """The logical axes of each block's leaves are the reference's
    (``mamba2_specs``, ``mlstm_specs``, ``slstm_specs``)."""
    mc, xc = J.Mamba2Config(**MCFG), J.XLSTMConfig(**XCFG)
    assert T.mamba2_specs(T.Mamba2Config(**MCFG)) == J.mamba2_specs(mc)
    assert T.mlstm_specs(T.XLSTMConfig(**XCFG)) == J.mlstm_specs(xc)
    assert T.slstm_specs(T.XLSTMConfig(**XCFG)) == J.slstm_specs(xc)


def test_reference_hybrid_gradients_are_nan_past_24_tokens():
    """A reference quirk (ROADMAP Queue 3): zamba2-smoke's gradients through
    the chunked SSD (``repro.models.ssm._ssd_chunked``) are non-finite at 32
    tokens, where exp of the masked (upper-triangle) segment sums overflows
    and its zero mask gives 0 * inf in the backward.  The port's backward
    differentiates the sequential scan (``kernels/ssd/ops.py``): finite."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.model_zoo import get_model as jax_get_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import get_model

    jzoo = jax_get_model(jax_smoke("zamba2-7b"))
    jparams = jzoo.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(DataConfig(vocab=128, seq_len=32, global_batch=2)).batch(0)
    grads = jax.jit(jax.grad(lambda p, b: jzoo.loss(p, b)[0]))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    finite = [bool(jnp.all(jnp.isfinite(g))) for g in jax.tree_util.tree_leaves(grads)]
    assert len(finite) == 30 and finite.count(False) == 10
    tparams = _carry(jparams)
    tparams.requires_grad_(True)
    loss, _ = get_model(get_smoke_config("zamba2-7b")).loss(
        tparams, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in tparams.parameters())
