"""The port's MoE family on one device against the JAX package: the router
(top-k with ties, capacity, drops), ``moe_ffn_dense`` in f32 and bf16, the
three MoE smoke configs end to end (forward, aux, loss, decode), one-card
serving, and the init's peak memory (``common.stack_params``)."""

import dataclasses
import functools
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    BatchScheduler, Request, make_serve_step, serve_waves,
)

ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b", "paper-llama3-moe"]
# the dense family's tolerances (tests/test_torch_transformer.py): f32 on
# both sides, only the sum order and libm differ
F32 = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
# one MoE FFN in f32: D = 64 and F = 96 term sums in another order
FFN_F32 = dict(atol=1e-5, rtol=1e-5)
# in bf16 both sides round the same products and SiLU to bf16 (ulp 2^-8
# relative), but where the f32 sum inside a product differs in its last
# bit a rounding flips: a few bf16 ulps at the output's magnitude (< 2)
FFN_BF16_ATOL = 4 * 2 ** -7
# the reference's own bound on MoE decode against forward (capacity differs
# between batched and per-step routing; tests/test_models_smoke.py)
ARGMAX_AGREE = 0.7


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the router and one MoE FFN
# ---------------------------------------------------------------------------


def _cfgs(E=4, K=2, D=16, F=24, cf=1.25, shared=0):
    kw = dict(d_model=D, d_ff=F, num_experts=E, top_k=K, capacity_factor=cf,
              num_shared_experts=shared)
    return jax_moe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _moe_params(jcfg, dtype="float32", seed=0):
    dt = jax_common.DTypes(param=getattr(jnp, dtype), compute=getattr(jnp, dtype))
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, dt)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), dtype=dtype, device="cpu")
    return jp, ParamTree.from_state_dict(state), dt


def _route_pair(jcfg, tcfg, x, cap, router=None):
    jp, tp, jdt = _moe_params(jcfg)
    if router is not None:
        jp = dict(jp, router={"w": jnp.asarray(router)})
        tp = {"router": {"w": torch.from_numpy(router)}}
    want = jax_moe._route(jp, jcfg, jnp.asarray(x), jdt, cap)
    got = moe._route(tp["router"]["w"], tcfg, torch.from_numpy(x), C.DTypes(), cap)
    return want, got


def _queues(r):
    """The reference's per-slot form of a port Routing: (src_token,
    slot_gate, slot_valid), each (E, C), the inverse of its per-assignment
    slots."""
    T, K = r.slot.shape
    n, flat = r.num_experts * r.capacity, r.slot.reshape(-1)
    shape = (r.num_experts, r.capacity)

    def put(values, dtype):
        buf = torch.zeros(n + 1, dtype=dtype)
        return buf.index_put((flat,), values.to(dtype))[:-1].reshape(shape)

    return (put(torch.arange(T).repeat_interleave(K), torch.long),
            put(r.gate.reshape(-1), r.gate.dtype), put(flat < n, torch.bool))


def _assert_route_equal(want, got):
    (js, jg, jv, jaux, _), (ts, tg, tv), taux = want, _queues(got), got.aux
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("cf,binding", [(4.0, False), (0.5, True)])
def test_route_matches_jax(cf, binding):
    """Capacity not binding (every assignment kept) and binding (drops):
    the same slots, gates, valid flags and aux."""
    jcfg, tcfg = _cfgs(cf=cf)
    x = np.random.RandomState(1).randn(24, 16).astype(np.float32)
    cap = moe.capacity(tcfg, 24)
    want, got = _route_pair(jcfg, tcfg, x, cap)
    _assert_route_equal(want, got)
    kept = int(_queues(got)[2].sum())
    assert (kept < 24 * 2) if binding else (kept == 24 * 2)


def test_route_breaks_planted_ties_to_the_lower_expert():
    """Router columns 1 and 2 equal, so every token's probs tie there: the
    top-k picks expert 1 before 2, as jax.lax.top_k does."""
    jcfg, tcfg = _cfgs(E=4, K=2)
    rng = np.random.RandomState(2)
    w = rng.randn(16, 4).astype(np.float32)
    w[:, 2] = w[:, 1]
    w[:, 1] += 3.0 / 16  # experts 1 and 2 lead for most tokens
    w[:, 2] = w[:, 1]
    x = np.abs(rng.randn(20, 16)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
    _, idx = moe.top_k(probs, 2)
    assert torch.equal(probs[:, 1], probs[:, 2])
    both = (idx == 1).any(-1) & (idx == 2).any(-1)
    assert both.any() and bool((idx[both] == torch.tensor([1, 2])).all())
    assert bool(((idx == 2).any(-1) <= (idx == 1).any(-1)).all())  # 2 only with 1
    want, got = _route_pair(jcfg, tcfg, x, moe.capacity(tcfg, 20), router=w)
    _assert_route_equal(want, got)


@pytest.mark.parametrize("tokens,cf,cap", [(5, 1.0, 2), (3, 1.0, 2), (7, 1.0, 4)])
def test_capacity_rounds_half_to_even(tokens, cf, cap):
    """cf * T * K / E = 2.5 -> 2, 1.5 -> 2, 3.5 -> 4 (Python's round, as the
    reference); routing at that capacity equals JAX's."""
    jcfg, tcfg = _cfgs(cf=cf)
    assert cf * tokens * 2 / 4 % 1 == 0.5
    assert moe.capacity(tcfg, tokens) == cap
    x = np.random.RandomState(3).randn(tokens, 16).astype(np.float32)
    want, got = _route_pair(jcfg, tcfg, x, cap)
    assert got.slot.shape == (tokens, 2) and _queues(got)[0].shape == (4, cap)
    _assert_route_equal(want, got)


def test_moonshot_decode_capacity_is_one_at_four_slots():
    cfg = transformer._moe_cfg(get_config("moonshot-v1-16b-a3b"))
    assert moe.capacity(cfg, 4) == 1  # round(1.25 * 4 * 6 / 64) = round(0.469)
    assert moe.capacity(cfg, 4 * 1024) == 480


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_dense_matches_jax_f32(shared):
    jcfg, tcfg = _cfgs(D=64, F=96, shared=shared)
    jp, tp, jdt = _moe_params(jcfg)
    x = np.random.RandomState(4).randn(2, 12, 64).astype(np.float32)
    want, jaux = jax_moe.moe_ffn_dense(jp, jcfg, jnp.asarray(x), jdt)
    got, taux = moe.moe_ffn_dense(tp, tcfg, torch.from_numpy(x), C.DTypes())
    np.testing.assert_allclose(_np(got), np.asarray(want), **FFN_F32)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_dense_matches_jax_bf16(shared):
    jcfg, tcfg = _cfgs(D=64, F=96, shared=shared)
    jp, tp, jdt = _moe_params(jcfg, "bfloat16")
    x = np.random.RandomState(5).randn(2, 12, 64).astype(np.float32)
    want, _ = jax_moe.moe_ffn_dense(jp, jcfg, jnp.asarray(x, jnp.bfloat16), jdt)
    got, _ = moe.moe_ffn_dense(tp, tcfg, torch.from_numpy(x).bfloat16(),
                               C.DTypes(torch.bfloat16, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=FFN_BF16_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the three MoE smoke configs end to end
# ---------------------------------------------------------------------------


class _Jitted:
    def __init__(self, zoo):
        self.cfg = zoo.cfg
        self.init = jax.jit(zoo.init)
        self.init_cache = zoo.init_cache
        self.forward = jax.jit(zoo.forward)
        self.decode_step = jax.jit(zoo.decode_step)
        self.loss = jax.jit(zoo.loss)


@functools.lru_cache(maxsize=None)
def _jax(arch):
    jzoo = _Jitted(jax_get_model(jax_smoke(arch)))
    return jzoo, jzoo.init(jax.random.PRNGKey(0))


def _port(arch):
    _, jp = _jax(arch)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), dtype="float32", device="cpu")
    return get_model(get_smoke_config(arch)), ParamTree.from_state_dict(state)


def _tokens(vocab, B=2, S=16, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    _, jp = _jax(arch)
    zoo, _ = _port(arch)
    jshapes = {".".join(str(k.key) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert zoo.param_shapes() == jshapes
    assert jshapes["layers.moe.wi"] == (2, 4, 64, 96)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_carries_the_moe_leaves(dtype):
    """params_from_jax / params_to_jax over the MoE leaves: the stacked
    router (L, D, E) and experts (L, E, D, F) / (L, E, F, D), layout
    unchanged, both ways (bf16 crosses as f32, exactly)."""
    jzoo = jax_get_model(dataclasses.replace(jax_smoke("moonshot-v1-16b-a3b"),
                                             param_dtype=getattr(jnp, dtype)))
    np_tree = jax.tree_util.tree_map(np.asarray, jax.jit(jzoo.init)(jax.random.PRNGKey(1)))
    state = params_from_jax(np_tree, dtype=None, device="cpu")
    moe_np = np_tree["layers"]["moe"]
    assert state["layers.moe.router.w"].shape == (2, 64, 4)
    assert state["layers.moe.wi"].shape == state["layers.moe.wg"].shape == (2, 4, 64, 96)
    assert state["layers.moe.wo"].shape == (2, 4, 96, 64)
    assert state["layers.moe.wi"].dtype == getattr(torch, dtype)
    for k in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(state[f"layers.moe.{k}"].float().numpy(),
                                      moe_np[k].astype(np.float32))
    back = params_to_jax(ParamTree.from_state_dict(state).state_dict())
    for k in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(back["layers"]["moe"][k], moe_np[k].astype(np.float32))
    np.testing.assert_array_equal(back["layers"]["moe"]["router"]["w"],
                                  moe_np["router"]["w"].astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_loss_match_jax(arch):
    jzoo, jp = _jax(arch)
    zoo, tp = _port(arch)
    toks = _tokens(zoo.cfg.vocab, seed=7)
    want, jaux = jzoo.forward(jp, {"tokens": jnp.asarray(toks)})
    got, taux = zoo.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0
    tgt = np.roll(toks, -1, axis=1)
    jl, jm = jzoo.loss(jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})
    tl, tm = zoo.loss(tp, {"tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tgt)})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    """A multi-token fill, then two one-token steps."""
    jzoo, jp = _jax(arch)
    zoo, tp = _port(arch)
    toks = _tokens(zoo.cfg.vocab, S=8, seed=2)
    jc, tc = jzoo.init_cache(2, 12), zoo.init_cache(2, 12, device="cpu")
    for lo, hi in [(0, 6), (6, 7), (7, 8)]:
        want, jc = jzoo.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, lo:hi])})
        got, tc = zoo.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert tc["index"] == int(jc["index"]) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_agrees_with_forward(arch):
    """Teacher-forced decode against the parallel forward: argmax agreement
    above the reference's bound (tests/test_models_smoke.py)."""
    zoo, tp = _port(arch)
    toks = torch.from_numpy(_tokens(zoo.cfg.vocab, B=1, S=8, seed=3)).long()
    logits, _ = zoo.forward(tp, {"tokens": toks})
    cache = zoo.init_cache(1, 8, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = zoo.decode_step(tp, cache, {"tokens": toks[:, t:t + 1]})
        outs.append(lg)
    agree = (torch.cat(outs, 1).argmax(-1) == logits.argmax(-1)).float().mean().item()
    assert agree > ARGMAX_AGREE


def test_one_card_serving_answers_as_jax_decode():
    """serve_waves on moonshot-smoke (flash prefill, capacity dispatch in
    every call): each request's tokens equal a loop over JAX's decode_step
    on the same wave of 4 slots."""
    arch = "moonshot-v1-16b-a3b"
    jzoo, jp = _jax(arch)
    zoo = get_model(dataclasses.replace(get_smoke_config(arch), attn_impl="flash"))
    _, tp = _port(arch)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(2, zoo.cfg.vocab, 10), max_new=5) for i in range(4)]
    sched = BatchScheduler(slots=4, eos_id=-1)
    for r in reqs:
        sched.submit(r)
    (wave,) = serve_waves(zoo, make_serve_step(zoo, device="cpu"), tp, sched, 16, device="cpu")
    assert wave.decode_steps == 4 and all(r.done and len(r.generated) == 5 for r in reqs)
    prompts = jnp.asarray(np.stack([r.prompt for r in reqs]), jnp.int32)
    logits, _ = jzoo.forward(jp, {"tokens": prompts})
    np.testing.assert_allclose(_np(wave.prefill_last), np.asarray(logits[:, -1]), **F32)
    nxt = jnp.argmax(logits[:, -1], -1)
    _, cache = jzoo.decode_step(jp, jzoo.init_cache(4, 16), {"tokens": prompts})
    out = [np.asarray(nxt)]
    for _ in range(4):
        lg, cache = jzoo.decode_step(jp, cache, {"tokens": nxt[:, None]})
        nxt = jnp.argmax(lg[:, -1], -1)
        out.append(np.asarray(nxt))
    want = np.stack(out, 1)
    for r in reqs:
        assert r.generated == want[r.rid].tolist(), r.rid


@pytest.mark.parametrize("shape,axes,d_ff,error,match", [
    ((3, 2), ("data", "model"), 96, ValueError, "E % ep"),           # 4 experts over 3
    ((2, 4), ("data", "model"), 98, ValueError, "d_ff 98"),          # F = 98 over 4
    ((2, 2), ("pod", "model"), 96, NotImplementedError, "'data'"),   # no EP axis
])
def test_shard_plan_refuses_what_moe_ffn_ep_cannot_run(shape, axes, d_ff, error, match):
    """The reference's moe_ffn_ep asserts E % |data| == 0 and takes F split
    over "model": a plan whose layout cannot give that raises, and no dense
    path stands in for EP under a mesh."""
    import types

    from repro_torch.parallel.sharding import param_layout

    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    zoo = get_model(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_ff=d_ff)))
    mesh = types.SimpleNamespace(shape=shape, mesh_dim_names=axes)
    with pytest.raises(error, match=match):
        zoo.shard_plan(param_layout(zoo, mesh))


# ---------------------------------------------------------------------------
# the init's peak memory
# ---------------------------------------------------------------------------


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the tensors made inside the mode
    keep alive, after each op, and their peak."""

    def __init__(self):
        super().__init__()
        self.refs = {}   # storage ptr -> (nbytes, [weakrefs to its tensors])
        self.peak = 0

    def live(self) -> int:
        return sum(n for n, refs in self.refs.values() if any(r() is not None for r in refs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                entry = self.refs.get(st.data_ptr())
                if entry is None or all(r() is None for r in entry[1]):
                    entry = self.refs[st.data_ptr()] = (st.nbytes(), [])  # a freed address reused
                entry[1].append(weakref.ref(t))
        self.peak = max(self.peak, self.live())
        return out


def _old_stack_params(gen, n, init_fn):
    """The init before its repair: every layer built, then stacked."""
    layers = [init_fn(gen) for _ in range(n)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([nd[k] for nd in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return stack(layers)


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_stack_params_peak_is_the_stack_plus_one_layer():
    """moonshot-smoke's layers, 6 of them: the init holds at most the
    stacked params, one layer and the draw of its largest leaf (what
    ``trunc_normal`` holds while it draws); stacking a list held both
    copies."""
    cfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"), num_layers=6)
    layer = transformer._init_layer(torch.Generator().manual_seed(0), cfg, "cpu")
    one = _nbytes(layer)
    with _LiveBytes() as mode:
        C.trunc_normal(torch.Generator().manual_seed(0), layer["moe"]["wi"].shape, 1.0,
                       torch.float32, "cpu")
    draw = mode.peak

    def init_fn(g):
        return transformer._init_layer(g, cfg, "cpu")

    peaks = {}
    for name, fn in (("new", C.stack_params), ("old", _old_stack_params)):
        with _LiveBytes() as mode:
            stacked = fn(torch.Generator().manual_seed(0), 6, init_fn)
        peaks[name] = mode.peak
        assert _nbytes(stacked) == 6 * one
        del stacked
    assert 6 * one <= peaks["new"] <= 6 * one + one + draw, (peaks, one, draw)
    assert peaks["old"] >= 2 * 6 * one


@pytest.mark.parametrize("arch", ["llama3.2-3b", "moonshot-v1-16b-a3b"])
def test_stack_params_draws_as_before(arch):
    """The repaired init gives the bit-identical params of the stacked-list
    one from the same seed (every parity test and chip number keeps its
    weights)."""
    cfg = get_smoke_config(arch)

    def init_fn(g):
        return transformer._init_layer(g, cfg, "cpu")

    new = C.stack_params(torch.Generator().manual_seed(3), cfg.num_layers, init_fn)
    old = _old_stack_params(torch.Generator().manual_seed(3), cfg.num_layers, init_fn)
    flat_new, flat_old = tree_leaves(new), tree_leaves(old)
    assert len(flat_new) == len(flat_old)
    for a, b in zip(flat_new, flat_old):
        assert torch.equal(a, b)


def test_init_on_meta_takes_no_memory():
    """param_shapes builds the full moonshot on the meta device."""
    zoo = get_model(get_config("moonshot-v1-16b-a3b"))
    shapes = zoo.param_shapes()
    assert shapes["layers.moe.wi"] == (48, 64, 2048, 1408)
    cfg = get_config("moonshot-v1-16b-a3b")
    n = sum(int(np.prod(s)) for s in shapes.values())
    # param_count leaves out the norm scales (two a layer and the final one)
    assert n - int(cfg.param_count()) == (2 * cfg.num_layers + 1) * cfg.d_model
