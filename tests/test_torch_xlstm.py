"""The port's xLSTM LM (repro_torch.models.xlstm_lm) against
repro.models.xlstm_lm on the xlstm-125m-smoke config (f32, CPU): params,
forward, cache, decode (a multi-token fill, then steps) and greedy serving."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels.mlstm import mlstm as mlstm_mod  # noqa: E402
from repro_torch.models import xlstm_lm  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    BatchScheduler, Request, make_serve_step, serve_waves,
)

ARCH = "xlstm-125m"
# f32 on both sides: XLA and torch differ in sum order and libm only; 1e-4
# as test_model_ssm_equivalences (tests/test_kernels.py)
F32 = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax():
    zoo = jax_get_model(jax_smoke(ARCH))
    params = jax.jit(zoo.init)(jax.random.PRNGKey(0))
    return zoo, params, jax.jit(zoo.forward), jax.jit(zoo.decode_step)


def _port():
    _, jp, _, _ = _jax()
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), dtype="float32", device="cpu")
    return get_model(get_smoke_config(ARCH)), ParamTree.from_state_dict(sd)


def _tokens(S, B=2, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def test_param_tree_and_layer_kinds_match_jax():
    _, jp, _, _ = _jax()
    zoo, _ = _port()
    jshapes = {".".join(str(k.key) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tshapes = {k: tuple(v.shape) for k, v in zoo.init(0, device="cpu").state_dict().items()}
    assert tshapes == jshapes
    assert xlstm_lm._is_slstm_flags(zoo.cfg) == [False, False, False, True]
    assert [i for i, s in enumerate(xlstm_lm._is_slstm_flags(get_config(ARCH))) if s] == [3, 7, 11]


@pytest.mark.parametrize("S", [20, 70])  # one chunk; two chunks of 64 with a padded tail
def test_forward_matches_jax(S):
    _, jp, jfwd, _ = _jax()
    zoo, tp = _port()
    toks = _tokens(S)
    want, _ = jfwd(jp, {"tokens": jnp.asarray(toks)})
    got, aux = zoo.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, S, 128) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert mlstm_mod.LAUNCHES == 0  # the CPU runs no kernel


def test_init_cache_matches_jax():
    jzoo, _, _, _ = _jax()
    zoo, _ = _port()
    want, got = jzoo.init_cache(2, 12), zoo.init_cache(2, 12, device="cpu")
    assert got["index"] == int(want["index"]) == 0 and zoo.decode_tokens is None
    for kind, leaves in (("mlstm", "Cnm"), ("slstm", "cnm")):
        for leaf in leaves:
            g, w = got[kind][leaf], want[kind][leaf]
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_decode_matches_jax():
    """A 6-token fill, then one-token steps: logits and the recurrent state."""
    jzoo, jp, _, jdec = _jax()
    zoo, tp = _port()
    toks = _tokens(9, seed=2)
    jc, tc = jzoo.init_cache(2, 12), zoo.init_cache(2, 12, device="cpu")
    for lo, hi in [(0, 6), (6, 7), (7, 8), (8, 9)]:
        want, jc = jdec(jp, jc, {"tokens": jnp.asarray(toks[:, lo:hi])})
        got, tc = zoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert tc["index"] == int(jc["index"]) == 9
    for kind, leaves in (("mlstm", "Cnm"), ("slstm", "cnm")):
        for leaf in leaves:
            np.testing.assert_allclose(_np(tc[kind][leaf]), np.asarray(jc[kind][leaf]), **F32)


def test_wave_server_answers_with_jax_greedy_tokens():
    jzoo, jp, jfwd, jdec = _jax()
    zoo, tp = _port()
    rng = np.random.RandomState(4)
    reqs = [Request(rid=i, prompt=rng.randint(2, 128, 12), max_new=4) for i in range(3)]
    sched = BatchScheduler(slots=2, eos_id=-1)
    for r in reqs:
        sched.submit(r)
    waves = serve_waves(zoo, make_serve_step(zoo, device="cpu"), tp, sched, 16, device="cpu")
    assert [len(w.requests) for w in waves] == [2, 1] and sched.idle
    for w in waves:
        # prefill (chunkwise, divides by max(|q.n|, exp(-m))) vs the one-call
        # fill (recurrence, max(|q.n|, 1)): the normalisers differ where
        # |q.n| < 1; on these prompts the two agree within 1 % of the logits'
        # std
        a, b = w.prefill_last, w.fill_last
        assert (a - b).abs().max().item() <= 1e-2 * a.std().item()
        assert w.decode_steps == 3
    # JAX: forward for the first token, one call to fill, then steps
    for r in reqs:
        toks = jnp.asarray(r.prompt[None], jnp.int32)
        logits, _ = jfwd(jp, {"tokens": toks})
        out = [int(jnp.argmax(logits[0, -1]))]
        _, cache = jdec(jp, jzoo.init_cache(1, 16), {"tokens": toks})
        for _ in range(3):
            lg, cache = jdec(jp, cache, {"tokens": jnp.asarray([[out[-1]]], jnp.int32)})
            out.append(int(jnp.argmax(lg[0, -1])))
        assert r.generated == out, r.rid


def test_chip_smoke_layer_walk_reproduces_prefill_and_fill():
    """chip_smoke.xlstm_layer_walk, which gates each mLSTM layer on the
    card, walks the same two paths as the model's forward and decode_step."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    zoo, tp = _port()
    toks = torch.from_numpy(_tokens(70, seed=5)).long()
    rows, pre, fill = smoke.xlstm_layer_walk(zoo, tp, toks)
    want_pre = zoo.forward(tp, {"tokens": toks})[0][:, -1]
    want_fill = zoo.decode_step(tp, zoo.init_cache(2, 70, device="cpu"), {"tokens": toks})[0][:, -1]
    # the same ops, but the walk unembeds the last position alone: f32 sum
    # order only
    np.testing.assert_allclose(_np(pre), _np(want_pre), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(fill), _np(want_fill), atol=1e-5, rtol=1e-5)
    assert [r[1] for r in rows] == ["mlstm", "mlstm", "mlstm", "slstm"]
    # sLSTM has one form (a loop over time): its two outputs are equal
    assert rows[3][2] == (0.0, 0.0)
    # f32: the mLSTM forms differ only where the normalisers do
    assert all(r[2][0] < 1e-3 for r in rows)
