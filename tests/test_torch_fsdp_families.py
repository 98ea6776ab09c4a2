"""The port's sharded forms of the hybrid, xLSTM, whisper and vlm families
against the JAX package's, rank by rank.

``gspmd_fsdp`` on a (2, 2, 2) ("pod", "data", "model") world of 8 gloo ranks
(``torch_dist_worlds.families``) for zamba2-smoke (16 tokens: past 24 the
reference's chunked-SSD gradients are NaN, ``test_torch_ssm.py``),
xlstm-125m-smoke, whisper-smoke (with ``enc_embeds``) and qwen2-vl-smoke
(with ``positions3``), three steps each from the JAX init at ``PRNGKey(0)``,
against the reference's ``make_train_step`` (xLSTM's on (1, 4, 2): on
(2, 2, 2) the reference's xLSTM step is not its own function,
``test_reference_xlstm_step_on_three_axes_is_not_its_function``); then ``make_serve_step(mesh=)``
on (4, 2) ("data", "model") against the reference's: the prefill, the
prompt decoded one token a call (the hybrid's decode takes one), and every
cache leaf's blocks.  JAX runs in its own process on 8 forced host
devices; the two run one after the other (``torch_dist_worlds.run_in_turn``)."""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402
from test_torch_family_train import S_ENC, _grid3  # noqa: E402
from test_torch_fsdp import F32, JAX_LOSS_ATOL, RANKS, _tree  # noqa: E402
from test_torch_train import _assert_params_close  # noqa: E402

B, S = 8, 16
# the family whose reference step on (2, 2, 2) computes another function
# than its one-device loss (ROADMAP Queue 3): its steps are held against the
# reference's on (1, 4, 2), where it does not
XLSTM = "xlstm-125m"

JAX_SIDE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import whisper
from repro.models.model_zoo import get_model
from repro.serve.serve_step import make_serve_step
from repro.train.optimizer import AdamWConfig, init as opt_init
from repro.train.train_step import make_train_step

workdir, steps = sys.argv[1], int(sys.argv[2])
archs, serve_archs = sys.argv[3].split(","), sys.argv[4].split(",")
slots, cache_len, quirk = int(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
inp = np.load(workdir + "/inputs.npz")
ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
out = {}

def batch(arch, i):
    pre = f"{arch}/{i}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        res = {}
        for k, v in tree.items():
            res.update(flat(v, f"{prefix}{k}."))
        return res
    return {prefix[:-1]: tree}

def blocks(mesh, sharding, shape):
    idx = sharding.devices_indices_map(tuple(shape))
    return np.array([[[s.start or 0, shape[d] if s.stop is None else s.stop]
                      for d, s in enumerate(idx[mesh.devices[c]])]
                     for c in np.ndindex(*mesh.devices.shape)])

def run(zoo, arts, n, record=False):
    p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    o = jax.device_put(opt_init(ocfg, zoo.init(jax.random.PRNGKey(0))), arts.opt_sharding)
    losses, gnorms = [], []
    for i in range(n):
        b = batch(arch, i)
        if record:  # the params before the step
            for k, v in flat(jax.tree_util.tree_map(np.asarray, p)).items():
                out[f"{arch}.before{i}.{k}"] = v
        p, o, m = arts.step_fn(p, o, {k: jax.device_put(v, arts.batch_sharding[k])
                                      for k, v in b.items()})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return p, losses, gnorms

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
for arch in archs:
    zoo = get_model(get_smoke_config(arch))
    arts = make_train_step(zoo, ocfg, mesh, batch(arch, 0))
    shard, mu_shard = flat(arts.param_sharding), flat(arts.opt_sharding.mu)
    if arch == quirk:
        # its (2, 2, 2) step is not its one-device function: the steps run on
        # (1, 4, 2), the blocks are (2, 2, 2)'s
        out[f"{arch}.quirk.loss"] = run(zoo, arts, 1)[1]
        out[f"{arch}.single.loss"] = float(jax.jit(zoo.loss)(zoo.init(jax.random.PRNGKey(0)),
                                                             batch(arch, 0))[0])
        arts = make_train_step(zoo, ocfg, make_mesh((1, 4, 2), ("pod", "data", "model")),
                               batch(arch, 0))
    p, out[f"{arch}.loss"], out[f"{arch}.grad_norm"] = run(zoo, arts, steps, arch == quirk)
    if arch == quirk:
        # each recorded step's one-device gradient, the mLSTM through the
        # reference's kernel op (whose backward differentiates the
        # sequential oracle, as the port's does) in place of the chunked jnp
        # form that the model differentiates
        from repro import models
        from repro.kernels.mlstm import ops as mlstm_ops
        chunked = models.ssm._mlstm_chunked
        models.ssm._mlstm_chunked = mlstm_ops.mlstm
        grad = jax.jit(jax.grad(lambda q, b: zoo.loss(q, b)[0]))
        for i in range(steps):
            pre = f"{arch}.before{i}."
            before = {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}
            tree = {}
            for k, v in before.items():
                node = tree
                *parents, leaf = k.split(".")
                for name in parents:
                    node = node.setdefault(name, {})
                node[leaf] = v
            for k, v in flat(grad(tree, batch(arch, i))).items():
                out[f"{arch}.grad{i}.{k}"] = np.asarray(v)
        models.ssm._mlstm_chunked = chunked
    for k, v in flat(p).items():
        out[f"{arch}.param.{k}"] = np.asarray(v)
        out[f"{arch}.block.{k}"] = blocks(mesh, shard[k], v.shape)
        out[f"{arch}.mu_block.{k}"] = blocks(mesh, mu_shard[k], v.shape)

mesh = make_mesh((4, 2), ("data", "model"))
for arch in serve_archs:
    cfg = get_smoke_config(arch)
    zoo = get_model(cfg)
    prompt = inp[f"{arch}/prompt"]
    cache_ex = jax.eval_shape(lambda: zoo.init_cache(slots, cache_len))
    tok = {"tokens": jnp.zeros((slots, 1), jnp.int32)}
    arts = make_serve_step(zoo, mesh, tok, cache_example=cache_ex)
    p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    cache = jax.device_put(zoo.init_cache(slots, cache_len), arts.cache_sharding)
    pre = {"tokens": prompt}
    prefill = arts.prefill_fn
    if cfg.family == "whisper":
        enc = inp[f"{arch}/enc_embeds"]
        pre["enc_embeds"] = enc
        prefill = make_serve_step(zoo, mesh, pre, cache_example=cache_ex).prefill_fn
        cache["enc_out"] = jax.device_put(jax.jit(lambda q, e: whisper.encode(q, cfg, e))(p, enc),
                                          arts.cache_sharding["enc_out"])
    out[f"serve.{arch}.prefill"] = np.asarray(prefill(p, pre))
    for i in range(prompt.shape[1]):
        logits, cache = arts.decode_fn(p, cache, {"tokens": prompt[:, i:i + 1]})
        out[f"serve.{arch}.decode{i}"] = np.asarray(logits)
    cshard = flat(arts.cache_sharding)
    for k, v in flat(cache).items():
        out[f"serve.{arch}.cache.{k}"] = np.asarray(v)
        out[f"serve.{arch}.cache_block.{k}"] = blocks(mesh, cshard[k], np.shape(v))
np.savez(workdir + "/jax.npz", **out)
"""


def _inputs():
    out = {}
    rng = np.random.RandomState(0)
    for arch in worlds.FAMILY_ARCHS:
        cfg = jax_smoke(arch)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
        for i in range(worlds.TRAIN_STEPS):
            batch = data.batch(i)
            if cfg.family == "whisper":
                batch["enc_embeds"] = rng.randn(B, S_ENC, cfg.d_model).astype(np.float32)
            if cfg.family == "vlm":
                batch["positions3"] = _grid3(B, S, 3)
            out.update({f"{arch}/{i}/{k}": v for k, v in batch.items()})
        out[f"{arch}/prompt"] = rng.randint(0, cfg.vocab, (worlds.SERVE_SLOTS, 7)).astype(
            np.int64)
        if cfg.family == "whisper":
            out[f"{arch}/enc_embeds"] = rng.randn(worlds.SERVE_SLOTS, S_ENC,
                                                  cfg.d_model).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process, then the port's worlds."""
    work = tmp_path_factory.mktemp("families")
    np.savez(work / "inputs.npz", **_inputs())
    init = {}
    for arch in worlds.FAMILY_ARCHS:
        jparams = jax_get_model(jax_smoke(arch)).init(jax.random.PRNGKey(0))
        init.update({f"{arch}.{k}": v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), dtype="float32", device="cpu").items()})
    np.savez(work / "params.npz", **init)
    cmds = {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work),
                str(worlds.TRAIN_STEPS), ",".join(worlds.FAMILY_ARCHS),
                ",".join(worlds.FAMILY_SERVE), str(worlds.SERVE_SLOTS), str(worlds.SERVE_CACHE),
                XLSTM],
        "families": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "families",
                     str(RANKS), str(work)],
    }
    worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, RANKS))
    return {"jax": dict(np.load(work / "jax.npz")),
            "port": [dict(np.load(work / f"families_{r}.npz")) for r in range(RANKS)]}


@pytest.mark.parametrize("arch", worlds.FAMILY_ARCHS)
def test_gspmd_fsdp_matches_jax(runs, arch):
    """Three gspmd_fsdp steps on (2, 2, 2), as the reference's: loss,
    grad_norm and the gathered params after them at test_torch_fsdp.py's
    tolerances (xLSTM: each step's gradients from the reference's params
    before it, whose AdamW steps on near-zero gradients drift, against the
    reference's through its mLSTM kernel op); every rank
    reports the same global numbers."""
    want, got = runs["jax"], runs["port"][0]
    np.testing.assert_allclose(got[f"{arch}.loss"], want[f"{arch}.loss"], atol=JAX_LOSS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[f"{arch}.grad_norm"], want[f"{arch}.grad_norm"],
                               rtol=JAX_LOSS_ATOL, atol=0)
    if arch == XLSTM:
        # each step's gradients from the reference's params before the step,
        # leaf by leaf, each within the grad norm's tolerance of the
        # reference's (in norm: at the third step's params the port's own
        # one-process and sharded gradients differ by 1.5e-4 of a leaf's
        # largest element, reduction order alone)
        for i in range(worlds.TRAIN_STEPS):
            g, w = _tree(got, f"{arch}.grad{i}."), _tree(want, f"{arch}.grad{i}.")
            assert g and set(g) == set(w)
            for k in w:
                err = torch.linalg.vector_norm(g[k] - w[k]).item()
                assert err <= JAX_LOSS_ATOL * torch.linalg.vector_norm(w[k]).item(), (i, k, err)
    else:
        _assert_params_close(_tree(got, f"{arch}.param."), _tree(want, f"{arch}.param."))
    for r in range(1, RANKS):
        for what in ("loss", "grad_norm"):
            np.testing.assert_array_equal(runs["port"][r][f"{arch}.{what}"], got[f"{arch}.{what}"])


def test_reference_xlstm_step_on_three_axes_is_not_its_function(runs):
    """A reference quirk: with "pod", "data" and "model" all of size 2, the
    reference's GSPMD xLSTM step returns a first loss that is not its own
    one-device loss of the same params and batch (5.1703 against 5.2330;
    on (1, 4, 2), (2, 4, 1) and (2, 1, 4) it is).  The port's (2, 2, 2)
    step gives the one-device loss."""
    want, got = runs["jax"], runs["port"][0]
    single = float(want[f"{XLSTM}.single.loss"])
    assert abs(float(want[f"{XLSTM}.quirk.loss"][0]) - single) > 1e-2
    np.testing.assert_allclose(float(want[f"{XLSTM}.loss"][0]), single, rtol=1e-6)
    np.testing.assert_allclose(float(got[f"{XLSTM}.loss"][0]), single, rtol=1e-6)


@pytest.mark.parametrize("arch", worlds.FAMILY_ARCHS)
def test_blocks_sit_as_jax_named_sharding(runs, arch):
    """Every param and AdamW-moment block each rank holds is the block that
    the reference's NamedSharding gives its mesh coordinate (checked
    against the gathered leaves, so a block in the wrong place fails)."""
    want = runs["jax"]
    for r, port in enumerate(runs["port"]):
        for kind, local in (("block", "local"), ("mu_block", "local_mu")):
            keys = [k for k in port if k.startswith(f"{arch}.{local}.")]
            assert keys
            for k in keys:
                leaf = k[len(f"{arch}.{local}."):]
                idx = want[f"{arch}.{kind}.{leaf}"][r]
                assert tuple(b - a for a, b in idx) == port[k].shape, (k, r)
                if kind == "block":
                    block = port[f"{arch}.param.{leaf}"][tuple(slice(a, b) for a, b in idx)]
                    np.testing.assert_array_equal(port[k], block, err_msg=f"{k} rank {r}")


def test_the_recurrent_families_split_their_heads_over_model(runs):
    """On (2, 2, 2) the Mamba2 out_proj and the xLSTM head projections hold
    a rank's "model" block: the blocks above are the ones that the heads'
    split computes with, not whole leaves gathered for a replicated run."""
    port = runs["port"][0]
    z, x = jax_smoke("zamba2-7b"), jax_smoke("xlstm-125m")
    d_inner = 2 * z.d_model
    assert port["zamba2-7b.local.groups.mix.out_proj.w"].shape[-2:] == (d_inner // 2,
                                                                          z.d_model // 2)
    assert port["xlstm-125m.local.layers.mlstm.wq.w"].shape[-1] == x.d_model // 2
    assert port["xlstm-125m.local.layers.mlstm.wi.w"].shape[-1] == x.heads


@pytest.mark.parametrize("arch", worlds.FAMILY_SERVE)
def test_sharded_decode_matches_jax(runs, arch):
    """make_serve_step(mesh=) on (4, 2): the prefill and each one-token
    decode step give the reference's whole logits on every rank, and each
    rank's cache leaves are the reference's blocks of its final cache."""
    want = runs["jax"]
    steps = [k for k in want if k.startswith(f"serve.{arch}.decode")]
    assert len(steps) == 7
    leaves = [k for k in want if k.startswith(f"serve.{arch}.cache.")]
    assert leaves
    for r, port in enumerate(runs["port"]):
        np.testing.assert_allclose(port[f"serve.{arch}.prefill"], want[f"serve.{arch}.prefill"],
                                   **F32)
        for k in steps:
            np.testing.assert_allclose(port[k], want[k], **F32, err_msg=k)
        for k in leaves:
            leaf = k[len(f"serve.{arch}.cache."):]
            if leaf == "index":
                assert int(port[k]) == int(want[k]) == 7
                continue
            idx = want[f"serve.{arch}.cache_block.{leaf}"][r]
            block = want[k][tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_allclose(port[k], block, **F32, err_msg=f"{k} rank {r}")
