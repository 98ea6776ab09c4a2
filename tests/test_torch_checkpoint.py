"""The port's checkpoints against the JAX package's: same layout and leaf
paths, so that a checkpoint written by either restores in the other, with
the optimizer state."""

import io
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ARCH = "llama3.2-3b"


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_state():
    """Port params and AdamW state after one train step (non-zero moments)."""
    cfg = get_smoke_config(ARCH)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params = get_model(cfg).init(0, device="cpu")
    opt = opt_lib.init(ocfg, params)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab, (2, 16)), "targets": rng.randint(0, cfg.vocab, (2, 16))}
    params, opt, _ = make_train_step(get_model(cfg), ocfg, device="cpu")(params, opt, batch)
    return params, opt


def _jax_like():
    zoo = jax_get_model(jax_smoke(ARCH))
    params = jax.eval_shape(lambda: zoo.init(jax.random.PRNGKey(0)))
    return {"params": params,
            "opt": jax.eval_shape(lambda p: jax_opt.init(jax_opt.AdamWConfig(), p), params)}


def test_port_save_restores_in_jax(tmp_path):
    params, opt = _port_state()
    ckpt.save(str(tmp_path), 5, {"params": params, "opt": opt}, extra={"step": 5})
    tree, extra = jax_ckpt.restore(str(tmp_path), _jax_like())
    assert extra == {"step": 5} and jax_ckpt.latest_step(str(tmp_path)) == 5
    assert int(tree["opt"].step) == 1
    got = _flat(tree)
    for k, v in params.state_dict().items():
        np.testing.assert_array_equal(np.asarray(got["params/" + k.replace(".", "/")]), v.numpy())
    for k in opt.mu:
        path = k.replace(".", "/")
        np.testing.assert_array_equal(np.asarray(got["opt/mu/" + path]), opt.mu[k].numpy())
        np.testing.assert_array_equal(np.asarray(got["opt/nu/" + path]), opt.nu[k].numpy())


def test_jax_save_restores_in_the_port(tmp_path):
    zoo = jax_get_model(jax_smoke(ARCH))
    jparams = zoo.init(jax.random.PRNGKey(1))
    jcfg = jax_opt.AdamWConfig()
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    jparams, jopt, _ = jax_opt.apply(jcfg, jax_opt.init(jcfg, jparams), jparams, grads)
    jax_ckpt.save(str(tmp_path), 3, {"params": jparams, "opt": jopt}, extra={"step": 3})

    like_params = get_model(get_smoke_config(ARCH)).init(0, device="cpu")
    like = {"params": like_params, "opt": opt_lib.init(opt_lib.AdamWConfig(), like_params)}
    tree, extra = ckpt.restore(str(tmp_path), like)
    assert extra == {"step": 3}
    assert isinstance(tree["params"], ParamTree) and tree["opt"].step == 1
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dtype="float32",
                           device="cpu")
    for k, v in tree["params"].state_dict().items():
        assert torch.equal(v, want[k])
    mu = params_from_jax(jax.tree_util.tree_map(np.asarray, jopt.mu), dtype="float32",
                         device="cpu")
    for k, v in tree["opt"].mu.items():
        assert torch.equal(v, mu[k])


def test_both_packages_write_the_same_leaf_paths(tmp_path):
    params, opt = _port_state()
    ckpt.save(str(tmp_path / "port"), 1, {"params": params, "opt": opt})
    like = _jax_like()
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), like)
    jax_ckpt.save(str(tmp_path / "jax"), 1, zeros)

    def manifest(d):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            return json.load(f)["leaves"]

    port, jx = manifest(tmp_path / "port"), manifest(tmp_path / "jax")
    assert set(port) == set(jx)
    assert all(port[k] == jx[k] for k in jx)  # file names, shapes and dtypes


def test_bf16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    rng = np.random.RandomState(2)
    a = jnp.asarray(rng.randn(4, 6), jnp.bfloat16)
    jax_ckpt.save(str(tmp_path / "jax"), 1, {"w": a})
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    ckpt.save(str(tmp_path / "port"), 1, {"w": t})

    def leaf(d):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            meta = json.load(f)["leaves"]["w"]
        with open(os.path.join(d, "step_00000001", meta["file"]), "rb") as f:
            data = f.read()
        if meta["file"].endswith(".zst"):
            data = ckpt.zstd.ZstdDecompressor().decompress(data)
        return meta, data

    (jm, jbytes), (tm, tbytes) = leaf(tmp_path / "jax"), leaf(tmp_path / "port")
    assert jm == tm and jm["dtype"] == "bfloat16"
    assert jbytes == tbytes
    assert np.load(io.BytesIO(jbytes)).dtype == np.dtype("V2")
    tree, _ = ckpt.restore(str(tmp_path / "jax"), {"w": torch.zeros(4, 6, dtype=torch.bfloat16)})
    assert tree["w"].dtype == torch.bfloat16 and torch.equal(tree["w"], t)


def test_restore_raises_on_a_missing_leaf_or_a_wrong_shape(tmp_path):
    ckpt.save(str(tmp_path), 1, {"params": {"w": torch.zeros(4, 6)}})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), {"params": {"w": torch.zeros(4, 6)}, "x": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"params": {"w": torch.zeros(6, 4)}})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {})
