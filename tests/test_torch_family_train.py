"""Training the gemma3, vlm, whisper, hybrid and xLSTM families in the port
against the JAX package, on the CPU in f32: three AdamW steps of
gemma3-smoke (24 tokens, past its window of 8), qwen2-vl-smoke (tokens with
``positions3``, and embeddings with ``positions3``), whisper-smoke
(``enc_embeds``) and zamba2-smoke (24 tokens), and xlstm-smoke's three
steps' gradients, each from the reference's params before it,
each through the port's ``make_train_step`` on both attention paths (the
flash path runs the ``_Flash`` autograd Function, whose backward on CPU
tensors is the kernels' plain version), held against the reference's
``jax.value_and_grad(zoo.loss)`` + ``optimizer.apply``; and the
microbatched step with ``positions3`` (cut on its dim 1) against the
reference's ``make_train_step(..., microbatches=2)``."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)
STEPS = 3
# tests/test_torch_train.py's tolerances: f32 on both sides, XLA and torch
# differ in sum order only (~1e-6 on the loss and the grad norm); after
# AdamW steps 99.9 % of elements agree within 1e-6 abs and every one within
# 1e-4 (10 % of lr: an element whose grad is near zero has an unstable
# mhat / sqrt(vhat))
LOSS = dict(rtol=1e-5, atol=0)
PARAM_TIGHT, PARAM_SHARE, PARAM_MAX = 1e-6, 0.999, 1e-4

# name -> (arch, batch entries beside tokens / targets, B, S)
CASES = {
    "gemma3": ("gemma3-4b", (), 2, 24),
    "vlm_tokens": ("qwen2-vl-2b", ("positions3",), 2, 16),
    "vlm_embeds": ("qwen2-vl-2b", ("embeds", "positions3"), 2, 16),
    "whisper": ("whisper-large-v3", ("enc_embeds",), 2, 8),
    # past 24 tokens the reference's chunked-SSD gradients are NaN
    # (test_torch_ssm.py), so the hybrid is held at 24
    "hybrid": ("zamba2-7b", (), 2, 24),
}
# xlstm-smoke's grad norm drifts past LOSS over three AdamW steps on
# near-zero gradients, so each step's gradients are held from the
# reference's params before it (test_xlstm_step_gradients_match_jax)
XLSTM_CASE = ("xlstm-125m", (), 2, 24)
# a leaf's gradient against the reference's, relative to the leaf's largest
# element: the mLSTM backward's tolerance (test_torch_mlstm.py, 1e-4)
GRAD_RTOL = 1e-4
S_ENC = 12


def _grid3(B, S, side):
    """positions3 (3, B, S): a side x side patch grid (0, row, col), then
    text continuing at side in all three streams, shifted per row of B."""
    n = min(S, side * side)
    p = np.zeros((3, B, S), np.int32)
    for b in range(B):
        p[1, b, :n] = np.arange(n) // side + b
        p[2, b, :n] = np.arange(n) % side + b
        p[:, b, n:] = side + b + np.arange(S - n)
    return p


def _batches(case, B=None):
    """STEPS batches of ``case`` as numpy arrays, from seeds."""
    arch, extra, b, S = CASES[case] if case in CASES else XLSTM_CASE
    B = B or b
    cfg = jax_smoke(arch)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    out = []
    for i in range(STEPS):
        batch = data.batch(i)
        rng = np.random.RandomState(100 + i)
        if "positions3" in extra:
            batch["positions3"] = _grid3(B, S, 3)
        if "embeds" in extra:
            batch["embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
            del batch["tokens"]
        if "enc_embeds" in extra:
            batch["enc_embeds"] = rng.randn(B, S_ENC, cfg.d_model).astype(np.float32)
        out.append(batch)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    zoo = jax_get_model(jax_smoke(arch))
    return zoo, zoo.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The reference's STEPS steps: [(metrics, params as numpy)]."""
    zoo, params = _jax_init((CASES[case] if case in CASES else XLSTM_CASE)[0])
    jcfg = jax_opt.AdamWConfig(**OCFG)

    @jax.jit
    def step(p, o, b):
        (loss, metrics), grads = jax.value_and_grad(zoo.loss, has_aux=True)(p, b)
        p, o, om = jax_opt.apply(jcfg, o, p, grads)
        return p, o, {"loss": loss, **metrics, **om}

    opt = jax_opt.init(jcfg, params)
    out = []
    for batch in _batches(case):
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append(({k: float(v) for k, v in m.items()},
                    jax.tree_util.tree_map(np.asarray, params)))
    return out


def _port_params(arch):
    np_tree = jax.tree_util.tree_map(np.asarray, _jax_init(arch)[1])
    return ParamTree.from_state_dict(params_from_jax(np_tree, dtype="float32", device="cpu"),
                                     requires_grad=True)


def _compare_params(tparams, np_tree):
    want = params_from_jax(np_tree, dtype="float32", device="cpu")
    got = tparams.state_dict()
    assert set(got) == set(want)
    diff = torch.cat([(got[k].detach() - want[k]).abs().flatten() for k in want])
    assert diff.max().item() <= PARAM_MAX
    assert (diff <= PARAM_TIGHT).float().mean().item() >= PARAM_SHARE


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
@pytest.mark.parametrize("case", list(CASES))
def test_three_train_steps_match_jax(case, attn_impl):
    arch = CASES[case][0]
    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl=attn_impl)
    ocfg = opt_lib.AdamWConfig(**OCFG)
    params = _port_params(arch)
    opt = opt_lib.init(ocfg, params)
    step_fn = make_train_step(get_model(cfg), ocfg, device="cpu")
    for batch, (jm, jparams) in zip(_batches(case), _jax_run(case)):
        params, opt, tm = step_fn(params, opt, batch)
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), jm[key], **LOSS)
        assert float(tm["aux"]) == 0.0
        _compare_params(params, jparams)
    assert opt.step == STEPS


@pytest.mark.parametrize("case", ["vlm_tokens", "vlm_embeds"])
def test_microbatched_step_with_positions3_matches_jax_make_train_step(case):
    """positions3 (3, B, S) is cut on its dim 1, as the reference's
    ``split_micro`` cuts it (cutting dim 0 gives slices of 2 and 1
    streams, and the step fails)."""
    arch = CASES[case][0]
    jzoo, jparams = _jax_init(arch)
    jcfg = jax_opt.AdamWConfig(**OCFG)
    batches = _batches(case, B=4)
    mesh = make_mesh((1,), ("data",))
    arts = jax_make_train_step(jzoo, jcfg, mesh, batches[0], microbatches=2)
    ocfg = opt_lib.AdamWConfig(**OCFG)
    tparams = _port_params(arch)
    topt = opt_lib.init(ocfg, tparams)
    step_fn = make_train_step(get_model(get_smoke_config(arch)), ocfg, microbatches=2,
                              device="cpu")
    # fresh buffers: the step donates its inputs, and jparams is shared
    jp = jax.device_put(jax.tree_util.tree_map(np.asarray, jparams), arts.param_sharding)
    jo = jax.device_put(jax_opt.init(jcfg, jparams), arts.opt_sharding)
    for batch in batches[:2]:
        jb = {k: jax.device_put(v, arts.batch_sharding[k]) for k, v in batch.items()}
        jp, jo, jm = arts.step_fn(jp, jo, jb)
        tparams, topt, tm = step_fn(tparams, topt, batch)
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **LOSS)
        _compare_params(tparams, jax.tree_util.tree_map(np.asarray, jp))


def _grads(tparams):
    return {k: p.grad for k, p in tparams.named_parameters()}


@pytest.mark.parametrize("step", range(STEPS))
def test_xlstm_step_gradients_match_jax(step):
    """xlstm-smoke's step ``step`` from the reference's params before it
    (its trajectory of three AdamW steps): the port's loss and each leaf's
    gradient against ``jax.value_and_grad(zoo.loss)``, and the port's step
    (``make_train_step``) from those params gives the reference's grad norm."""
    arch = XLSTM_CASE[0]
    jzoo, jinit = _jax_init(arch)
    before = jax.tree_util.tree_map(np.asarray, jinit) if step == 0 else \
        _jax_run("xlstm")[step - 1][1]
    batch = _batches("xlstm")[step]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jzoo.loss, has_aux=True))(
        before, {k: jnp.asarray(v) for k, v in batch.items()})
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), dtype="float32",
                           device="cpu")
    zoo = get_model(get_smoke_config(arch))
    tparams = ParamTree.from_state_dict(params_from_jax(before, dtype="float32", device="cpu"),
                                        requires_grad=True)
    loss, _ = zoo.loss(tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
    got = _grads(tparams)
    assert set(got) == set(want)
    for k, g in got.items():
        scale = want[k].abs().max().item()
        assert (g - want[k]).abs().max().item() <= GRAD_RTOL * scale, k
    ocfg = opt_lib.AdamWConfig(**OCFG)
    tparams = ParamTree.from_state_dict(params_from_jax(before, dtype="float32", device="cpu"),
                                        requires_grad=True)
    _, _, tm = make_train_step(zoo, ocfg, device="cpu")(tparams, opt_lib.init(ocfg, tparams),
                                                         batch)
    jnorm = float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                              for g in jax.tree_util.tree_leaves(jgrads))))
    np.testing.assert_allclose(float(tm["grad_norm"]), jnorm, **LOSS)
