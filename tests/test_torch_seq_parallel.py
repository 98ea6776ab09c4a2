"""The port's sequence parallelism over "model" (the reference's ``seq ->
"model"`` rule) for every family, against the JAX package.

One gloo world of 8 ranks (``torch_dist_worlds.sp``) runs, from the JAX
inits at ``PRNGKey(0)``, each case of ``SP_CASES``:

* llama3.2-3b-smoke on (1, 1, 8), where the dry run's ``attention_overrides``
  set ``seq -> "model"`` (4 heads over 8);
* gemma3-4b-smoke at S 32 on (1, 2, 4), whose window of 8 crosses the ranks'
  blocks of 8 positions;
* qwen2-vl-2b-smoke with ``embeds`` and ``positions3`` on (1, 2, 4);
* whisper-large-v3-smoke on (1, 2, 4) (the encoder's frames cut too);
* zamba2-7b-smoke at S 16 on (1, 2, 4): its Mamba2 layers run split, 2 of
  the 8 heads a rank (``out_proj``'s rows stay on "model");
* xlstm-125m-smoke at S 16 on (1, 2, 4): its mLSTM and sLSTM run whole on
  every rank (``heads: None`` keeps their projections whole);
* moonshot-v1-16b-a3b-smoke at S 16 on (1, 2, 4): experts over "data",
  their F dim over "model" (``gspmd_fsdp`` only, as the reference);

each under ``{"heads": None, "kv_heads": None, "seq": "model"}`` where the
rules are not the dry run's: two steps of ``gspmd_fsdp`` and of
``manual_hier``, and the sharded prefill.  JAX runs the reference's
``make_train_step`` and ``make_serve_step`` with the same meshes and
overrides in its own process on 8 forced host devices; its MoE prefill
reports each device's expert queues from inside its ``shard_map``
(``jax.debug.callback``).  zamba2 stays at S 16: the reference's hybrid
gradients are NaN from S 32 up."""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    attention_overrides, cut_positions, param_layout, rank_batch, seq_axes,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import torch_dist_worlds as worlds  # noqa: E402
from test_torch_family_train import S_ENC, _grid3  # noqa: E402
from test_torch_fsdp import F32, JAX_LOSS_ATOL, RANKS, _tree  # noqa: E402
from test_torch_tp_manual_hier import _Mesh, _hist_close  # noqa: E402
from test_torch_train import _assert_params_close  # noqa: E402

B = 8

JAX_SIDE = """
import sys
import numpy as np, jax
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import get_model
from repro.parallel.sharding import attention_overrides
from repro.serve.serve_step import make_serve_step
from repro.train.optimizer import AdamWConfig, init as opt_init
from repro.train.train_step import make_train_step
import repro.models.moe as jmoe

workdir, steps = sys.argv[1], int(sys.argv[2])
cases = [c.split("@") for c in sys.argv[3].split(",")]
inp = np.load(workdir + "/inputs.npz")
ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
out = {}

def batch(name, i):
    pre = f"tp/sp.{name}/{i}/"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        res = {}
        for k, v in tree.items():
            res.update(flat(v, f"{prefix}{k}."))
        return res
    return {prefix[:-1]: tree}

def overrides(cfg, shape, explicit, kind):
    if explicit == "dry":
        return attention_overrides(cfg, shape[-1], kind)
    return {"heads": None, "kv_heads": None, "seq": "model"}

real_route, routes = jmoe._route, []

def route(p, cfg, xt, dt, capacity):
    # the reference's routing, reporting the device's coordinates and its
    # expert queues (src_token, slot_valid) from inside the shard_map
    res = real_route(p, cfg, xt, dt, capacity)
    coord = [jax.lax.axis_index(a) for a in ("pod", "data", "model")]
    jax.debug.callback(lambda *a: routes.append([np.asarray(v) for v in a]), *coord, res[0],
                       res[2])
    return res

for name, arch, shape, explicit, modes in cases:
    shape = tuple(int(c) for c in shape)
    cfg = get_smoke_config(arch)
    zoo = get_model(cfg)
    mesh = make_mesh(shape, ("pod", "data", "model"))
    for mode in modes.split("+"):
        tag = f"sp.{name}.{mode}"
        arts = make_train_step(zoo, ocfg, mesh, batch(name, 0), dp_mode=mode,
                               schedule="hierarchical",
                               rules_overrides=overrides(cfg, shape, explicit, "train"))
        p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
        o = jax.device_put(opt_init(ocfg, zoo.init(jax.random.PRNGKey(0))), arts.opt_sharding)
        hist = {"loss": [], "grad_norm": []}
        for i in range(steps):
            b = batch(name, i)
            p, o, m = arts.step_fn(p, o, {k: jax.device_put(v, arts.batch_sharding[k])
                                          for k, v in b.items()})
            for k in hist:
                hist[k].append(float(m[k]))
        out.update({f"{tag}.{k}": v for k, v in hist.items()})
        out.update({f"{tag}.param.{k}": np.asarray(v) for k, v in flat(p).items()})
    prompt = {k: v for k, v in batch(name, 0).items() if k != "targets"}
    arts = make_serve_step(zoo, mesh, prompt,
                           rules_overrides=overrides(cfg, shape, explicit, "prefill"))
    p = jax.device_put(zoo.init(jax.random.PRNGKey(0)), arts.param_sharding)
    routes.clear()
    jmoe._route = route
    out[f"sp.{name}.prefill"] = np.asarray(arts.prefill_fn(p, prompt))
    jax.effects_barrier()
    jmoe._route = real_route
    for i, (pod, data, model, src, valid) in enumerate(routes):
        out[f"sp.{name}.prefill.route{i}.coord"] = np.array([pod, data, model])
        out[f"sp.{name}.prefill.route{i}.src"] = src
        out[f"sp.{name}.prefill.route{i}.valid"] = valid
np.savez(workdir + "/jax.npz", **out)
"""


def _inputs():
    out = {}
    rng = np.random.RandomState(0)
    for name, (arch, _, S, _) in worlds.SP_CASES.items():
        cfg = jax_smoke(arch)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
        for i in range(worlds.SP_STEPS):
            batch = data.batch(i)
            if cfg.family == "whisper":
                batch["enc_embeds"] = rng.randn(B, S_ENC, cfg.d_model).astype(np.float32)
            if cfg.family == "vlm":
                batch["embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
                batch["positions3"] = _grid3(B, S, 3)
                del batch["tokens"]
            out.update({f"tp/sp.{name}/{i}/{k}": v for k, v in batch.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process, then the port's world."""
    work = tmp_path_factory.mktemp("seq_parallel")
    np.savez(work / "inputs.npz", **_inputs())
    init = {}
    for arch in {a for a, *_ in worlds.SP_CASES.values()}:
        jparams = jax_get_model(jax_smoke(arch)).init(jax.random.PRNGKey(0))
        init.update({f"{arch}.{k}": v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), dtype="float32", device="cpu").items()})
    np.savez(work / "params.npz", **init)
    cases = ",".join(f"{name}@{arch}@{''.join(map(str, mesh))}@{'dry' if ov is None else 'sp'}"
                     f"@{'+'.join(worlds.sp_modes(name))}"
                     for name, (arch, mesh, _, ov) in worlds.SP_CASES.items())
    cmds = {
        "jax": [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(work),
                str(worlds.SP_STEPS), cases],
        "sp": [sys.executable, os.path.join(HERE, "torch_dist_worlds.py"), "sp", str(RANKS),
               str(work)],
    }
    worlds.run_in_turn(tmp_path_factory, cmds, worlds.jax_env(SRC, RANKS))
    return {"jax": dict(np.load(work / "jax.npz")),
            "port": [dict(np.load(work / f"sp_{r}.npz")) for r in range(RANKS)]}


CASES = [(name, mode) for name in worlds.SP_CASES for mode in worlds.sp_modes(name)]
# the families whose blocks gather the positions, and what they run on
GATHERED = ("zamba2", "xlstm", "moe")
GATHERED_CASES = [(name, mode) for name, mode in CASES if name in GATHERED]


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_seq_parallel_steps_match_jax(runs, name, mode):
    """Two steps with the positions cut over "model", as the reference's
    steps under the same overrides: loss and grad_norm at
    test_torch_dist_train.py's tolerances, the gathered params after them at
    test_torch_fsdp.py's; every rank reports the same numbers."""
    tag = f"sp.{name}.{mode}"
    want, got = runs["jax"], runs["port"][0]
    assert str(got[f"{tag}.seq"]) == "model"
    _hist_close(got, want, tag, tag)
    _assert_params_close(_tree(got, f"{tag}.param."), _tree(want, f"{tag}.param."))
    for port in runs["port"][1:]:
        for what in ("loss", "grad_norm"):
            np.testing.assert_array_equal(port[f"{tag}.{what}"], got[f"{tag}.{what}"])


def _attention_lengths(name):
    """The (queries, keys) of a rank's attention calls: S / |model| query
    rows over all S keys (whisper: also its encoder's frames, S_ENC /
    |model| over S_ENC, and the cross-attention's S / |model| over S_ENC;
    the xLSTM has no attention)."""
    _, shape, S, _ = worlds.SP_CASES[name]
    m = shape[-1]
    if name == "xlstm":
        return set()
    want = {(S // m, S)}
    if name == "whisper":
        want |= {(S_ENC // m, S_ENC), (S // m, S_ENC)}
    return want


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_seq_parallel_attention_takes_the_ranks_rows_and_every_key(runs, name, mode):
    """On every rank each attention call of the step took the rank's
    S / |model| query rows and the keys of all S positions."""
    for port in runs["port"]:
        seen = {tuple(int(n) for n in row) for row in port[f"sp.{name}.{mode}.attn"]}
        assert seen == _attention_lengths(name)


@pytest.mark.parametrize("name", list(worlds.SP_CASES))
def test_seq_parallel_prefill_matches_jax(runs, name):
    """The sharded prefill under the same overrides returns the reference's
    whole logits on every rank, its attention on the rank's positions."""
    want = runs["jax"][f"sp.{name}.prefill"]
    for port in runs["port"]:
        np.testing.assert_allclose(port[f"sp.{name}.prefill"], want, **F32)
        seen = {tuple(int(n) for n in row) for row in port[f"sp.{name}.prefill.attn"]}
        assert seen == _attention_lengths(name)


def _stream(name):
    """What a rank's blocks take: the residual stream at S / |model|
    positions; zamba2's SSD scans over all S positions on 8 / |model| of
    the 8 Mamba2 heads (the mixers split); the xLSTM's blocks over all S
    on both heads (whole); the MoE layers on all S positions of the rank's
    rows."""
    _, shape, S, _ = worlds.SP_CASES[name]
    m = shape[-1]
    inner = {"zamba2": ("scan", S, 8 // m), "xlstm": ("scan", S, 2), "moe": ("moe", S)}[name]
    return {("block", S // m), inner}


@pytest.mark.parametrize("name,mode", GATHERED_CASES, ids=[f"{n}-{m}" for n, m in GATHERED_CASES])
def test_seq_parallel_blocks_hold_the_ranks_positions_between_them(runs, name, mode):
    """Between the blocks a rank's residual stream holds S / |model|
    positions; the blocks that mix positions gather them, and a Mamba2
    mixer whose layout splits it runs the rank's heads (``plan.ssm``), the
    xLSTM's, kept whole, all of them."""
    for port in runs["port"]:
        assert str(port[f"sp.{name}.{mode}.stream"]) == repr(sorted(_stream(name)))
        assert bool(port[f"sp.{name}.{mode}.ssm"]) == (name == "zamba2")
        assert str(port[f"sp.{name}.prefill.stream"]) == repr(sorted(_stream(name)))


def _queues(npz, prefix):
    """The expert queues of a prefill's routing calls, as a sorted list of
    (src_token, slot_valid) bytes."""
    n = len({k for k in npz if k.startswith(prefix) and k.endswith(".src")})
    return sorted((npz[f"{prefix}{i}.src"].astype(np.int64).tobytes(),
                   npz[f"{prefix}{i}.valid"].astype(bool).tobytes()) for i in range(n))


def test_seq_parallel_moe_prefill_routes_as_jax(runs):
    """The MoE prefill with the positions cut routes every rank's tokens to
    the reference's expert queues, slot for slot (the kept and the dropped
    assignments), layer by layer, on the device at the rank's coordinates."""
    jx = runs["jax"]
    _, shape, _, _ = worlds.SP_CASES["moe"]
    prefix = "sp.moe.prefill.route"
    n = len({k for k in jx if k.startswith(prefix) and k.endswith(".coord")})
    for rank, port in enumerate(runs["port"]):
        coord = np.unravel_index(rank, shape)
        mine = [i for i in range(n) if tuple(jx[f"{prefix}{i}.coord"]) == tuple(coord)]
        want = sorted((jx[f"{prefix}{i}.src"].astype(np.int64).tobytes(),
                       jx[f"{prefix}{i}.valid"].astype(bool).tobytes()) for i in mine)
        got = _queues(port, prefix)
        assert len(got) == get_smoke_config("moonshot-v1-16b-a3b").num_layers
        assert got == want


def _plan(arch, sizes, overrides):
    zoo = get_model(get_config(arch))
    mesh = _Mesh(sizes)
    return zoo.shard_plan(param_layout(zoo, mesh, overrides), seq_axes(mesh, overrides))


@pytest.mark.parametrize("arch,cut", [
    ("llama3.2-3b", True), ("gemma3-4b", True), ("qwen2-vl-2b", True),
    ("whisper-large-v3", True), ("zamba2-7b", True), ("xlstm-125m", True),
    ("moonshot-v1-16b-a3b", True)])
def test_seq_plan_cuts_positions_for_the_dense_vlm_and_whisper_families(arch, cut):
    """Under ``seq -> "model"`` on (16, 16) every family's plan cuts the
    positions and runs no attention, MLP or vocab split over "model"; the
    hybrid's Mamba2 heads stay split as the layout splits them (7 of
    zamba2-7b's 112 a rank), the xLSTM's blocks whole (``heads: None``),
    the MoE layers keep their expert parallelism."""
    plan = _plan(arch, {"data": 16, "model": 16}, worlds.SP_OVERRIDES)
    assert plan.seq == (("model",) if cut else ())
    assert not (plan.heads or plan.kv or plan.mlp or plan.embed_vocab or plan.head_vocab)
    assert plan.sp.axis == "model"
    assert plan.ssm == (arch == "zamba2-7b")
    assert (plan.ep is not None) == (arch == "moonshot-v1-16b-a3b")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma3-4b", "qwen2-vl-2b",
                                  "whisper-large-v3", "qwen3-8b"])
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)], ids=["pod1", "pod2"])
def test_seq_axes_follow_attention_overrides(arch, shape):
    """The rules cut the positions over "model" exactly where the
    reference's ``attention_overrides`` set ``seq`` (heads that do not
    divide 16), for train and prefill, and never for decode."""
    axes = ("pod", "data", "model")[-len(shape):]
    sizes = dict(zip(axes, shape))
    cfg = get_config(arch)
    for kind in ("train", "prefill", "decode"):
        ov = attention_overrides(cfg, 16, kind)
        want = ("model",) if cfg.heads % 16 and kind != "decode" else ()
        assert seq_axes(_Mesh(sizes), ov) == want


def test_seq_axes_refuse_an_axis_other_than_model():
    """Positions cut over "data" (the batch whole) are not the port's."""
    with pytest.raises(ValueError, match="seq"):
        seq_axes(_Mesh({"data": 2, "model": 2}), {"batch": None, "seq": "data"})
    assert seq_axes(_Mesh({"data": 2, "model": 1}), worlds.SP_OVERRIDES) == ()


class _Coord(_Mesh):
    def __init__(self, sizes, coord):
        super().__init__(sizes)
        self._coord = coord

    def get_coordinate(self):
        return self._coord


def test_cut_positions_gives_each_rank_its_block_and_refuses_what_does_not_divide():
    """Rank r of |model| holds positions [r S / m, (r + 1) S / m) of every
    entry (dim 2 of ``positions3``); S that |model| does not divide raises
    ``ValueError`` naming the rule."""
    batch = {"tokens": torch.arange(24).reshape(2, 12),
             "embeds": torch.arange(48.0).reshape(2, 12, 2),
             "positions3": torch.arange(72).reshape(3, 2, 12)}
    mine = cut_positions(batch, _Coord({"data": 2, "model": 4}, (1, 2)), ("model",))
    assert torch.equal(mine["tokens"], batch["tokens"][:, 6:9])
    assert torch.equal(mine["embeds"], batch["embeds"][:, 6:9])
    assert torch.equal(mine["positions3"], batch["positions3"][:, :, 6:9])
    with pytest.raises(ValueError, match="seq"):
        cut_positions({"tokens": torch.zeros(2, 10)}, _Coord({"model": 4}, (0,)), ("model",))


def test_rank_batch_cuts_the_rows_then_the_positions():
    """A rank's block of a batch: its rows over "data", then its block of
    positions over "model" (``positions3``'s rows on dim 1, positions on 2)."""
    batch = {"tokens": torch.arange(48).reshape(4, 12),
             "positions3": torch.arange(144).reshape(3, 4, 12)}
    mesh = _Coord({"data": 2, "model": 4}, (1, 3))
    mine = rank_batch(mesh, batch, seq=("model",))
    assert torch.equal(mine["tokens"], batch["tokens"][2:, 9:])
    assert torch.equal(mine["positions3"], batch["positions3"][:, 2:, 9:])
    rows = rank_batch(mesh, batch)
    assert torch.equal(rows["tokens"], batch["tokens"][2:])


def test_serve_step_reads_the_seq_rule_only_for_the_prefill():
    """Decode cuts no positions, so a ``seq`` rule the port does not run
    (over "data") builds the serve step; the prefill's plan refuses it."""
    from repro_torch.serve.serve_step import make_serve_step

    zoo = get_model(get_smoke_config("llama3.2-3b"))
    mesh = _Coord({"data": 2, "model": 2}, (0, 1))
    overrides = {"batch": None, "seq": "data"}
    arts = make_serve_step(zoo, "cpu", mesh=mesh, rules_overrides=overrides)
    assert arts.plan.seq == ()
    with pytest.raises(ValueError, match="seq"):
        arts.prefill_plan()
    ok = make_serve_step(zoo, "cpu", mesh=mesh, rules_overrides=worlds.SP_OVERRIDES)
    assert ok.prefill_plan().seq == ("model",)
