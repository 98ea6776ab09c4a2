"""The port's training path on the CPU against the JAX package: the data
pipeline, AdamW, the train step (plain and microbatched, remat on and off),
the trainer's resume-and-GC loop and the entry point.  Inputs come from
numpy seeds or from JAX's init carried over by params_from_jax."""

import dataclasses
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM, optimal_nll  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    CheckpointPolicy, StragglerAlert, StragglerMonitor, resume, train_loop,
)

ARCH = "llama3.2-3b"
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)
# f32 on both sides: XLA and torch differ in sum order only (~1e-6 on a loss
# of ~5 and on the grad norm).  Params after AdamW steps: an element moves by
# lr * mhat / (sqrt(vhat) + eps), which the two sides agree on to ~1e-6
# relative, so 99.9 % of elements agree within 1e-6 abs (0.1 % of lr); an
# element whose grad is near zero has an unstable ratio mhat / sqrt(vhat) and
# may differ by a fraction of one step, so every element stays within 1e-4
# (10 % of lr = 1e-3)
LOSS = dict(rtol=1e-5, atol=0)
PARAM_TIGHT, PARAM_SHARE, PARAM_MAX = 1e-6, 0.999, 1e-4


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,shard,shards", [(0, 0, 1), (3, 1, 2), (17, 3, 4)])
def test_synthetic_lm_batches_are_bit_identical_to_jax(step, shard, shards):
    kw = dict(vocab=96, seq_len=24, global_batch=8)
    got = SyntheticLM(DataConfig(**kw)).batch(step, shard, shards)
    want = jax_pipeline.SyntheticLM(jax_pipeline.DataConfig(**kw)).batch(step, shard, shards)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_optimal_nll_matches_jax():
    kw = dict(vocab=64, seq_len=12, global_batch=8)
    assert optimal_nll(DataConfig(**kw)) == jax_pipeline.optimal_nll(jax_pipeline.DataConfig(**kw))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2, 5, 10, 20, 25])
def test_lr_schedule_matches_jax(step):
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=20, min_lr_frac=0.1)
    want = float(jax_opt.lr_schedule(jax_opt.AdamWConfig(**cfg), jnp.asarray(step)))
    # both in f32; XLA's and numpy's cos may differ by one ulp
    np.testing.assert_allclose(opt_lib.lr_schedule(opt_lib.AdamWConfig(**cfg), step), want,
                               rtol=2e-7)


def _adamw_trees(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5), "stack": {"s": rng.randn(3, 4, 2)}, "scale": rng.randn(5),
            "b": rng.randn(4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_step_by_step(dtype):
    """Four steps on identical grads; the grads' global norm (~30) is above
    grad_clip, so clipping is engaged."""
    jcfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.0)
    tcfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.0)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), _adamw_trees(0))
    tparams = ParamTree.from_state_dict(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype=dtype, device="cpu"))
    jstate, tstate = jax_opt.init(jcfg, jparams), opt_lib.init(tcfg, tparams)
    step = jax.jit(lambda s, p, g: jax_opt.apply(jcfg, s, p, g))
    for i in range(4):
        grads = jax.tree_util.tree_map(lambda a: jnp.asarray(a * 8.0, getattr(jnp, dtype)),
                                       _adamw_trees(10 + i))
        jparams, jstate, jm = step(jstate, jparams, grads)
        tgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads), dtype=dtype,
                                 device="cpu")
        tparams, tstate, tm = opt_lib.apply(tcfg, tstate, tparams, tgrads)
        assert float(jm["grad_norm"]) > tcfg.grad_clip
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=2e-7)
        assert tstate.step == int(jstate.step)
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype=dtype,
                               device="cpu")
        # f32: one rounding apart; bf16: the f32 updates may round to
        # neighbouring bf16 values (one ulp, 2^-7 relative)
        tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
        for k, v in tparams.state_dict().items():
            assert v.dtype == getattr(torch, dtype)
            torch.testing.assert_close(v.float(), want[k].float(), **tol)
        mu = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.mu), dtype="float32",
                             device="cpu")
        for k, v in tstate.mu.items():
            assert v.dtype == torch.float32
            torch.testing.assert_close(v, mu[k], rtol=1e-5, atol=1e-7)


def test_adamw_decays_matrices_only():
    cfg = opt_lib.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    params = ParamTree({"w": torch.ones(3, 3), "stack": torch.ones(2, 3), "b": torch.ones(3)})
    state = opt_lib.init(cfg, params)
    zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    params, state, m = opt_lib.apply(cfg, state, params, zeros)
    assert float(m["grad_norm"]) == 0.0
    assert torch.all(params["b"] == 1.0)                 # 1-D: no decay
    assert torch.all(params["w"] < 1.0) and torch.all(params["stack"] < 1.0)


def test_adamw_chunked_update_equals_whole_leaf(monkeypatch):
    cfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=0)
    g = torch.Generator().manual_seed(0)
    leaf = torch.randn(7, 5, 3, generator=g)
    grad = {"w": torch.randn(7, 5, 3, generator=g)}
    whole = ParamTree({"w": leaf.clone()})
    opt_lib.apply(cfg, opt_lib.init(cfg, whole), whole, grad)
    monkeypatch.setattr(opt_lib, "CHUNK", 30)  # 2 rows of 15 per chunk
    chunked = ParamTree({"w": leaf.clone()})
    opt_lib.apply(cfg, opt_lib.init(cfg, chunked), chunked, grad)
    assert len(opt_lib._chunks(chunked["w"])) == 4
    torch.testing.assert_close(chunked["w"], whole["w"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_setup(microbatches=1):
    cfg = jax_smoke(ARCH)
    zoo = jax_get_model(cfg)
    return cfg, zoo, zoo.init(jax.random.PRNGKey(0))


def _port_params(jparams):
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32",
                            device="cpu")
    return ParamTree.from_state_dict(state, requires_grad=True)


def _data(cfg, global_batch=4):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=global_batch))


def _assert_params_close(got, want):
    assert set(got) == set(want)
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    assert diff.max().item() <= PARAM_MAX
    assert (diff <= PARAM_TIGHT).float().mean().item() >= PARAM_SHARE


def _compare_params(tparams, jparams):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32",
                           device="cpu")
    _assert_params_close(tparams.state_dict(), want)


def test_three_train_steps_match_jax():
    cfg, jzoo, jparams = _jax_setup()
    jcfg = jax_opt.AdamWConfig(**OCFG)

    @jax.jit
    def jstep(p, o, b):
        (loss, metrics), grads = jax.value_and_grad(jzoo.loss, has_aux=True)(p, b)
        p, o, om = jax_opt.apply(jcfg, o, p, grads)
        return p, o, {"loss": loss, **metrics, **om}

    ocfg = opt_lib.AdamWConfig(**OCFG)
    tparams = _port_params(jparams)
    topt = opt_lib.init(ocfg, tparams)
    step_fn = make_train_step(get_model(get_smoke_config(ARCH)), ocfg, device="cpu")
    jopt = jax_opt.init(jcfg, jparams)
    data = _data(cfg)
    for i in range(3):
        batch = data.batch(i)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, topt, tm = step_fn(tparams, topt, batch)
        assert set(tm) == {"loss", "nll", "aux", "grad_norm", "lr"}
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **LOSS)
        assert float(tm["aux"]) == 0.0
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=2e-7)
        _compare_params(tparams, jparams)
    assert topt.step == 3


def test_microbatched_step_matches_jax_make_train_step():
    cfg, jzoo, jparams = _jax_setup()
    jcfg = jax_opt.AdamWConfig(**OCFG)
    data = _data(cfg, global_batch=4)
    mesh = make_mesh((1,), ("data",))
    arts = jax_make_train_step(jzoo, jcfg, mesh, data.batch(0), microbatches=2)
    ocfg = opt_lib.AdamWConfig(**OCFG)
    tparams = _port_params(jparams)
    topt = opt_lib.init(ocfg, tparams)
    step_fn = make_train_step(get_model(get_smoke_config(ARCH)), ocfg, microbatches=2,
                              device="cpu")
    # fresh buffers: the step donates its inputs, and jparams is shared
    jp = jax.device_put(jax.tree_util.tree_map(np.asarray, jparams), arts.param_sharding)
    jo = jax.device_put(jax_opt.init(jcfg, jparams), arts.opt_sharding)
    for i in range(2):
        batch = data.batch(i)
        jb = {k: jax.device_put(v, arts.batch_sharding[k]) for k, v in batch.items()}
        jp, jo, jm = arts.step_fn(jp, jo, jb)
        tparams, topt, tm = step_fn(tparams, topt, batch)
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **LOSS)
        _compare_params(tparams, jp)


def test_remat_on_and_off_agree():
    cfg = get_smoke_config(ARCH)
    ocfg = opt_lib.AdamWConfig(**OCFG)
    state = get_model(cfg).init(0, device="cpu").state_dict()
    batch = _data(cfg).batch(0)
    out = []
    for remat in (False, True):
        params = ParamTree.from_state_dict({k: v.clone() for k, v in state.items()},
                                           requires_grad=True)
        step_fn = make_train_step(get_model(dataclasses.replace(cfg, remat=remat)), ocfg,
                                  device="cpu")
        params, _, m = step_fn(params, opt_lib.init(ocfg, params), batch)
        out.append((float(m["loss"]), float(m["grad_norm"]), params.state_dict()))
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-6)
    _assert_params_close(out[1][2], out[0][2])


def test_train_step_rejects_a_batch_that_does_not_split():
    cfg = get_smoke_config(ARCH)
    ocfg = opt_lib.AdamWConfig(**OCFG)
    params = get_model(cfg).init(0, device="cpu")
    step_fn = make_train_step(get_model(cfg), ocfg, microbatches=3, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step_fn(params, opt_lib.init(ocfg, params), _data(cfg).batch(0))


def test_params_to_jax_inverts_params_from_jax():
    _, _, jparams = _jax_setup()
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = params_to_jax(params_from_jax(np_tree, dtype="bfloat16", device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(np_tree))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert leaf.dtype == np.float32 and leaf.shape == flat_b[path].shape
        want = np.asarray(jnp.asarray(flat_b[path], jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(leaf, want)


# ---------------------------------------------------------------------------
# trainer and entry point
# ---------------------------------------------------------------------------


def test_trainer_resume_and_gc(tmp_path):
    """tests/test_checkpoint.py::test_trainer_resume_and_gc on the port:
    train, checkpoint, resume from fresh state, continue."""
    cfg = get_smoke_config(ARCH)
    zoo = get_model(cfg)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    params = zoo.init(0, device="cpu")
    opt = opt_lib.init(ocfg, params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    step_fn = make_train_step(zoo, ocfg, device="cpu")

    pol = CheckpointPolicy(str(tmp_path), every_steps=3, keep_last=2)
    res = train_loop(step_fn, params, opt, data.batches(0), num_steps=7, ckpt=pol,
                     log_every=100, log_fn=lambda s: None)
    assert res.steps_done == 7
    assert ckpt_lib.latest_step(str(tmp_path)) == 6
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(kept) == 2

    fresh = zoo.init(1, device="cpu")
    p2, o2, start = resume(str(tmp_path), fresh, opt_lib.init(ocfg, fresh))
    assert start == 6 and o2.step == 6
    assert all(p.requires_grad is False for p in p2.parameters())
    res2 = train_loop(step_fn, p2, o2, data.batches(start), num_steps=9, start_step=start,
                      log_every=100, log_fn=lambda s: None)
    assert res2.steps_done == 3
    assert res2.history[-1]["step"] == 8


def test_straggler_monitor_raises_and_recovers():
    mon = StragglerMonitor(threshold=2.0, patience=2)
    for dt in (1.0, 1.0, 5.0, 1.0, 5.0):
        mon.observe(dt)  # a recovery resets the streak
    with pytest.raises(StragglerAlert):
        mon.observe(5.0)


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "4", "--seq-len", "16",
            "--global-batch", "4", "--microbatches", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    launch_train.main(argv)
    launch_train.main(argv[:4] + ["6"] + argv[5:] + ["--resume"])
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "resumed at step 4" in out and "done: 2 steps" in out
    assert ckpt_lib.latest_step(str(tmp_path)) == 6
