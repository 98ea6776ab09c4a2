"""AdamW's multi-tensor kernels (``repro_torch/kernels/adamw``): on the CPU
the wrapper's pure-Python parts (the launches a table takes, the tensor
table, the dtype and decay codes, what it refuses) and ``optimizer.apply``
keeping its plain code there; on the card (marked ``cuda``, skipped
elsewhere) the kernels against the plain version, at the benchmark's 16
leaves and on small ragged, misaligned and f32 tables.  No JAX here.

    python -m pytest -m cuda tests/test_torch_adamw.py
"""

import ctypes
import dataclasses
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEParams  # noqa: E402
from repro_torch.kernels.adamw import adamw as fused  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32
# the benchmark's model: moonshot-v1-16b-a3b at 4 layers (portbench/configs)
BENCH_CONFIG = ROOT / "portbench" / "configs" / "moonshot-v1-16b-a3b-l4.json"
BENCH_PARAMS = 3_022_538_752
H100_SMS = 132
# a ragged table: numels not multiples of the vector width or of a tile, 1-D
# leaves (no decay), one element, a stacked (L, D) scale
RAGGED = [(7, 5, 3), (4097,), (3, 1365), (1,), (2, 33), (fused.TILE + 5, 3)]


def _bench_shapes():
    c = json.loads(BENCH_CONFIG.read_text())
    fields = dict(c["model"])
    fields["moe"] = MoEParams(**fields["moe"])
    return get_model(dataclasses.replace(get_config(c["run"]["registry"]), **fields)).param_shapes()


def _meta_leaves(shapes, p_dtype, g_dtype):
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return [fused.Leaf(t(s, p_dtype), t(s, g_dtype), t(s, F32), t(s, F32), len(s) >= 2)
            for s in shapes]


# ---------------------------------------------------------------------------
# CPU: the wrapper's pure-Python parts
# ---------------------------------------------------------------------------


def test_the_wrapper_constants_are_the_cuda_sources():
    src = (Path(fused.__file__).parent / "csrc" / "adamw.cu").read_text()
    want = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kThreads", "kVec", "kUnroll", "kBlocksPerSm", "kMaxLeaves")}
    assert (fused.THREADS, fused.VEC, fused.UNROLL, fused.BLOCKS_PER_SM, fused.MAX_LEAVES) == \
        tuple(want.values())
    assert fused.TILE == fused.THREADS * fused.VEC * fused.UNROLL
    # one bit a leaf in the table's decay and alignment masks
    assert fused.MAX_LEAVES <= 64


@pytest.mark.parametrize("numel, tiles", [(0, 0), (1, 1), (fused.TILE, 1), (fused.TILE + 1, 2),
                                          (738_197_504, 180_224)])
def test_a_leaf_takes_whole_tiles(numel, tiles):
    assert fused.tiles(numel) == tiles


@pytest.mark.parametrize("n_tiles, sms, want", [(0, 132, 1), (5, 132, 5), (10**6, 132, 264),
                                                (10**6, 114, 228)])
def test_the_grid_is_persistent_and_never_wider_than_the_tiles(n_tiles, sms, want):
    assert fused.grid(n_tiles, sms) == want


@pytest.mark.parametrize("keys, want", [
    (["a"] * 3, [[0, 1, 2]]),
    (["a", "b", "a", "b"], [[0, 2], [1, 3]]),
    (["a"] * 130, [list(range(64)), list(range(64, 128)), [128, 129]]),
    (["a", "b"] * 65, [list(range(0, 128, 2)), [128], list(range(1, 129, 2)), [129]]),
    ([], []),
])
def test_groups_split_by_dtype_then_by_the_leaves_a_launch_holds(keys, want):
    assert fused.groups(keys) == want


@pytest.mark.parametrize("g_dtype", [BF16, F32])
def test_the_benchmark_table_takes_three_launches(g_dtype):
    """16 leaves of 3.02 B params, bf16 params with bf16 (1k) or f32 (8k)
    gradients: one norm launch, the finalize, one update launch."""
    shapes = _bench_shapes()
    assert len(shapes) == 16 and sum(math.prod(s) for s in shapes.values()) == BENCH_PARAMS
    leaves = _meta_leaves(shapes.values(), BF16, g_dtype)
    norm = fused.sum_sq_launches([leaf.g for leaf in leaves], H100_SMS)
    upd = fused.update_launches(leaves, H100_SMS)
    assert len(norm) + 1 + len(upd) == 3
    (part, code, grid), = norm
    assert len(part) == 16 and code == fused.DTYPES[g_dtype] and grid == 2 * H100_SMS
    (part, p_code, g_code, grid), = upd
    assert (p_code, g_code, grid) == (0, fused.DTYPES[g_dtype], 2 * H100_SMS)
    # decayed: every leaf with ndim >= 2, the stacked (L, D) norm scales too
    assert [leaf.decay for leaf in part] == [len(s) >= 2 for s in shapes.values()]
    assert sum(leaf.decay for leaf in part) == 15


def test_mixed_dtypes_take_one_update_launch_a_pair():
    shapes = [(3, 4)] * 3
    leaves = (_meta_leaves(shapes, BF16, BF16) + _meta_leaves(shapes, F32, BF16)
              + _meta_leaves(shapes[:1], BF16, F32) + _meta_leaves(shapes[:1], BF16, BF16))
    upd = fused.update_launches(leaves, H100_SMS)
    assert [(len(part), p, g) for part, p, g, _ in upd] == [(4, 0, 0), (3, 1, 0), (1, 0, 1)]
    norm = fused.sum_sq_launches([leaf.g for leaf in leaves], H100_SMS)
    assert [(len(part), code, grid) for part, code, grid in norm] == [(7, 0, 7), (1, 1, 1)]


def test_the_table_holds_each_tensors_pointer_and_numel():
    ts = [torch.zeros(s) for s in RAGGED]
    ptrs, ns = fused.table(ts), fused.numels(ts)
    assert isinstance(ptrs, ctypes.Array) and list(ptrs) == [t.data_ptr() for t in ts]
    assert list(ns) == [t.numel() for t in ts]


def _cpu_leaf(shape=(4, 6), p=BF16, g=BF16, mu=F32, nu=F32):
    return fused.Leaf(torch.zeros(shape, dtype=p), torch.zeros(shape, dtype=g),
                      torch.zeros(shape, dtype=mu), torch.zeros(shape, dtype=nu), True)


@pytest.mark.parametrize("leaf, error, match", [
    (_cpu_leaf(p=torch.float16), TypeError, "p 0 must be bfloat16 or float32"),
    (_cpu_leaf(g=torch.float64), TypeError, "g 0 must be bfloat16 or float32"),
    (_cpu_leaf(mu=BF16), TypeError, "mu 0 must be float32"),
    (_cpu_leaf(nu=torch.float64), TypeError, "nu 0 must be float32"),
    (_cpu_leaf()._replace(g=torch.zeros(6, 4, dtype=BF16).t()), ValueError,
     "g 0 must be contiguous"),
    (_cpu_leaf()._replace(p=torch.zeros(4, 12, dtype=BF16)[:, ::2]), ValueError,
     "p 0 must be contiguous"),
    (_cpu_leaf()._replace(mu=torch.zeros(6, 4).t()), ValueError, "mu 0 must be contiguous"),
    (_cpu_leaf()._replace(nu=torch.zeros(4, 7)[:, :6]), ValueError, "nu 0 must be contiguous"),
    (_cpu_leaf()._replace(nu=torch.zeros(24)), ValueError, "nu 0 has shape"),
    (_cpu_leaf(), ValueError, "p 0 must lie on a CUDA device"),
])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(leaf, error, match):
    with pytest.raises(error, match=match):
        fused.check([leaf])
    with pytest.raises(error, match=match):
        fused.update([leaf], torch.ones(()), opt_lib.kernel_scalars(opt_lib.AdamWConfig(),
                                                                    1e-3, 0.1, 0.05))


@pytest.mark.parametrize("g, match", [(torch.zeros(4, 6, dtype=torch.float16), "bfloat16 or"),
                                      (torch.zeros(6, 4).t(), "contiguous"),
                                      (torch.zeros(4, 6), "CUDA device")])
def test_the_norm_refuses_what_the_kernels_do_not_take(g, match):
    with pytest.raises((TypeError, ValueError), match=match):
        fused.sum_sq([g])


def test_the_kernel_scalars_are_the_plain_versions_scalars():
    cfg = opt_lib.AdamWConfig(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                              grad_clip=1.0, warmup_steps=2, total_steps=2000)
    lr, b1c, b2c = opt_lib.step_scalars(cfg, 5)
    f = np.float32
    assert b1c == float(f(1) - f(0.9) ** f(5)) and b2c == float(f(1) - f(0.95) ** f(5))
    assert lr == opt_lib.lr_schedule(cfg, 5)
    h = opt_lib.kernel_scalars(cfg, lr, b1c, b2c)
    assert h._fields == ("clip", "lr", "b1", "b2", "omb1", "omb2", "b1c", "b2c", "eps", "wd")
    assert (h.omb1, h.omb2, h.wd, h.clip) == (1 - 0.9, 1 - 0.95, 0.1, 1.0)
    # ctypes rounds each to f32 as PyTorch rounds a Python scalar for an f32 op
    assert ctypes.c_float(h.omb1).value == float(f(1 - 0.9))


def test_apply_on_the_cpu_runs_the_plain_code_and_counts_nothing():
    cfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=0)
    gen = torch.Generator().manual_seed(0)
    params = ParamTree({"w": torch.randn(5, 3, generator=gen), "b": torch.randn(3, generator=gen)})
    grads = {n: torch.randn(p.shape, generator=gen) for n, p in params.named_parameters()}
    want = {n: p.detach().clone() for n, p in params.named_parameters()}
    mu = {n: torch.zeros_like(p) for n, p in want.items()}
    nu = {n: torch.zeros_like(p) for n, p in want.items()}
    gnorm = opt_lib._sum_sq_plain(grads.values(), root=True)
    lr, b1c, b2c = opt_lib.step_scalars(cfg, 1)
    opt_lib._update_plain(cfg, want, grads, mu, nu, gnorm, lr, b1c, b2c)
    fused.reset_launch_counts()
    tracer = obs.Tracer()
    with obs.tracing(tracer):
        params, state, m = opt_lib.apply(cfg, opt_lib.init(cfg, params), params, grads)
    assert sum(fused.launch_counts().values()) == 0
    assert "optimizer.fused" not in tracer.counter_totals()
    assert torch.equal(m["grad_norm"], gnorm)
    for n, p in params.named_parameters():
        assert torch.equal(p.detach(), want[n]) and torch.equal(state.mu[n], mu[n])


@pytest.mark.parametrize("g_dtype", [BF16, F32])
def test_a_dry_run_traces_the_cards_three_operators_and_their_bytes(g_dtype):
    """On the meta device ``apply`` dispatches the operators the card runs,
    launching nothing, and the dry run's counter prices them at the bytes
    the kernels move: g read twice, p, mu, nu read and written once."""
    from repro_torch.launch import roofline

    meta = torch.device("meta")
    params = ParamTree.from_state_dict({f"l{i}": torch.empty(s, dtype=BF16, device=meta)
                                        for i, s in enumerate(RAGGED)})
    cfg = opt_lib.AdamWConfig()
    state = opt_lib.init(cfg, params)
    grads = {n: torch.empty(p.shape, dtype=g_dtype, device=meta)
             for n, p in params.named_parameters()}
    ops = []

    class Recorder(roofline.TraceCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func._overloadpacket))
            return super().__torch_dispatch__(func, types, args, kwargs)

    fused.reset_launch_counts()
    counter = Recorder(external=[*params.parameters(), *state.mu.values(), *state.nu.values(),
                                 *grads.values()])
    with counter:
        _, _, m = opt_lib.apply(cfg, state, params, grads)
    assert sum(fused.launch_counts().values()) == 0
    assert m["grad_norm"].device == meta
    assert [op for op in ops if op.startswith("repro_torch_adamw")] == [
        "repro_torch_adamw.sum_sq", "repro_torch_adamw.norm_finalize", "repro_torch_adamw.update"]
    assert set(ops) <= {"repro_torch_adamw.sum_sq", "repro_torch_adamw.norm_finalize",
                        "repro_torch_adamw.update", "aten.empty", "aten.detach"}
    n = sum(math.prod(s) for s in RAGGED)
    g_size = g_dtype.itemsize
    partials = 8 * fused.grid(sum(fused.tiles(math.prod(s)) for s in RAGGED), fused.META_SMS)
    # every tensor argument counts as read, one written in place once more:
    # sum_sq g and the partials, the partials again; finalize the partials
    # and the norm, the norm again; update g, p, mu, nu and the norm, then
    # p, mu, nu again
    want = (n * g_size + 2 * partials) + (partials + 2 * 4) + (n * (g_size + 2 * (2 + 4 + 4)) + 4)
    assert counter.hbm_bytes == want
    assert counter.peak == partials + 4


def test_the_plain_norm_with_root_is_the_square_root_of_the_sum():
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn(s, generator=gen) for s in RAGGED]
    total = opt_lib._sum_sq(grads)
    assert torch.equal(opt_lib._sum_sq(grads, root=True), torch.sqrt(total))
    assert torch.equal(opt_lib.global_norm(grads), torch.sqrt(total))
    want = sum(float(np.sum(np.square(g.double().numpy()))) for g in grads)
    assert abs(float(total) - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# the card: kernels against the plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spacing(m: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at |m| (f64 in, f64 out)."""
    _, e = torch.frexp(m)
    bits = {BF16: 8, F32: 24}[dtype]
    return torch.ldexp(torch.ones_like(m), e - bits).clamp(min=2.0 ** -149)


def _max_ulps(got: torch.Tensor, want: torch.Tensor, before: torch.Tensor, dtype) -> float:
    """The largest |got - want| in units of the last place of ``dtype`` at
    the larger of |got|, |want| and the value ``before`` the step (an
    update that nearly cancels it leaves a small result whose own ulp says
    nothing of the arithmetic)."""
    worst = 0.0
    for a, b, c in zip(*(t.reshape(-1).split(1 << 25) for t in (got, want, before))):
        a, b, c = a.double(), b.double(), c.double()
        m = torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs())
        worst = max(worst, float(((a - b).abs() / _spacing(m, dtype)).max()))
    return worst


def _init_leaf(i: int, shape, p_dtype, device, seed: int = 0):
    """Leaf ``i``'s params and moments, as after a few steps; the same
    tensors every call."""
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + i)
    p = (0.02 * torch.randn(shape, generator=gen, device=device)).to(p_dtype)
    mu = 1e-3 * torch.randn(shape, generator=gen, device=device)
    nu = torch.square(1e-3 * torch.randn(shape, generator=gen, device=device))
    return p, mu, nu


def _grad(i: int, shape, g_dtype, device, scale: float, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + 500 + i)
    return (scale * torch.randn(shape, generator=gen, device=device)).to(g_dtype)


def _exact_norm(grads) -> float:
    return math.sqrt(sum(float(torch.sum(torch.square(c.double())))
                         for g in grads for c in g.reshape(-1).split(1 << 25)))


def _check_against_plain(cfg, step, shapes, leaves, norm, p_dtype, device, seed=0, views=None,
                         on=None):
    """Each leaf as the kernel left it against the plain update, on device
    ``on``, of the same initial state with the same norm: bf16 params within
    one bf16 ulp, f32 params and the moments within a few f32 ulps (the
    chain's roundings may differ: an add with alpha is an fma in the kernel
    and may be two roundings on the CPU; on the card PyTorch divides by a
    scalar as a product with its reciprocal, the kernel as IEEE division)."""
    on = on or device
    lr, b1c, b2c = opt_lib.step_scalars(cfg, step)
    for i, (shape, leaf) in enumerate(zip(shapes, leaves)):
        p, mu, nu = views[i] if views else _init_leaf(i, shape, p_dtype, device, seed)
        p, mu, nu = (t.to(on) for t in (p, mu, nu))
        p0, mu0, nu0 = p.clone(), mu.clone(), nu.clone()
        opt_lib._update_plain(cfg, {"x": p}, {"x": leaf.g.to(on)}, {"x": mu}, {"x": nu},
                              norm.to(on), lr, b1c, b2c)
        for name, got, want, before, dtype, most in (("mu", leaf.mu, mu, mu0, F32, 4),
                                                     ("nu", leaf.nu, nu, nu0, F32, 4),
                                                     ("p", leaf.p, p, p0, p_dtype,
                                                      1 if p_dtype == BF16 else 4)):
            ulps = _max_ulps(got.to(on), want, before, dtype)
            assert ulps <= most, (i, shape, name, ulps)
        del p, mu, nu, p0, mu0, nu0


def _kernel_step(cfg, step, leaves):
    lr, b1c, b2c = opt_lib.step_scalars(cfg, step)
    norm = fused.sum_sq([leaf.g for leaf in leaves], root=True)
    fused.update(leaves, norm, opt_lib.kernel_scalars(cfg, lr, b1c, b2c))
    return norm


BENCH_CFG = opt_lib.AdamWConfig(lr=3e-4, b2=0.95, weight_decay=0.1, grad_clip=1.0,
                                warmup_steps=2, total_steps=2000)


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [BF16, F32])
def test_kernels_match_plain_at_the_benchmark_leaves(card, g_dtype):
    """The 16 leaves of moonshot-v1-16b-a3b-l4 at their shapes (3.02 B
    params, bf16), bf16 gradients (the 1k cell) or f32 ones (8k); clipping
    engaged (the norm of unit normals is ~5.5e4).  Through ``apply``: three
    launches, the ``optimizer.fused`` counter, the norm against the plain
    one and an f64 sum."""
    shapes = list(_bench_shapes().items())
    params = ParamTree.from_state_dict({name: _init_leaf(i, s, BF16, card)[0]
                                        for i, (name, s) in enumerate(shapes)})
    state = opt_lib.AdamWState(step=4, mu={}, nu={})
    for i, (name, s) in enumerate(shapes):
        _, state.mu[name], state.nu[name] = _init_leaf(i, s, BF16, card)
    grads = {name: _grad(i, s, g_dtype, card, 1.0) for i, (name, s) in enumerate(shapes)}
    plain_norm = float(opt_lib._sum_sq_plain(grads.values(), root=True))
    exact = _exact_norm(grads.values())
    fused.reset_launch_counts()
    tracer = obs.Tracer()
    with obs.tracing(tracer):
        params, state, m = opt_lib.apply(BENCH_CFG, state, params, grads)
    torch.cuda.synchronize()
    assert fused.launch_counts() == {"adamw_sum_sq": 1, "adamw_norm_finalize": 1,
                                     "adamw_update": 1}
    assert tracer.counter_totals()["optimizer.fused"] == {
        "leaves": 16, "elements": BENCH_PARAMS, "launches": 3}
    norm = float(m["grad_norm"])
    assert m["grad_norm"].dtype == F32 and m["grad_norm"].shape == ()
    assert abs(norm - exact) <= 1e-6 * exact and abs(norm - plain_norm) <= 1e-5 * exact
    assert norm > BENCH_CFG.grad_clip
    leaves = [fused.Leaf(p.detach(), grads[n], state.mu[n], state.nu[n], p.dim() >= 2)
              for n, p in params.named_parameters()]
    _check_against_plain(BENCH_CFG, 5, [s for _, s in shapes], leaves, m["grad_norm"], BF16,
                         card)


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", [BF16, F32])
@pytest.mark.parametrize("g_dtype", [BF16, F32])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-4, 0.0], ids=["clipped", "unclipped", "zero"])
def test_kernels_match_plain_on_a_ragged_table(card, p_dtype, g_dtype, grad_scale):
    """Numels that are no multiple of the vector width or of a tile, 1-D
    leaves, one element; clipping engaged (norm ~ 170), not engaged (norm ~
    0.02), and a zero gradient (norm 0: scale 1, the moments decay)."""
    cfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1)
    leaves = []
    for i, s in enumerate(RAGGED):
        p, mu, nu = _init_leaf(i, s, p_dtype, card, seed=1)
        leaves.append(fused.Leaf(p, _grad(i, s, g_dtype, card, grad_scale, seed=1), mu, nu,
                                 len(s) >= 2))
    fused.reset_launch_counts()
    norm = _kernel_step(cfg, 3, leaves)
    torch.cuda.synchronize()
    assert sum(fused.launch_counts().values()) == 3
    exact = _exact_norm(leaf.g for leaf in leaves)
    assert abs(float(norm) - exact) <= 1e-6 * exact
    if grad_scale == 1.0:
        assert float(norm) > cfg.grad_clip
    elif grad_scale:
        assert 0 < float(norm) < cfg.grad_clip
    else:
        assert float(norm) == 0.0
    _check_against_plain(cfg, 3, RAGGED, leaves, norm, p_dtype, card, seed=1, on="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", [BF16, F32])
def test_kernels_match_plain_on_leaves_that_are_not_16_byte_aligned(card, p_dtype):
    """Contiguous views one element into their storage: the kernels run
    such a leaf element by element."""
    cfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    shapes = [(3, 4097), (fused.TILE * 2 + 3,)]
    leaves, views = [], []
    for i, s in enumerate(shapes):
        n = math.prod(s)
        p, mu, nu = (t.reshape(-1) for t in _init_leaf(i, (n + 1,), p_dtype, card, seed=2))
        g = _grad(i, (n + 1,), BF16, card, 1.0, seed=2)
        cut = [t[1:].view(s) for t in (p, g, mu, nu)]
        assert all(t.is_contiguous() and t.data_ptr() % 16 for t in cut)
        leaves.append(fused.Leaf(cut[0], cut[1], cut[2], cut[3], len(s) >= 2))
        views.append(tuple(t.clone() for t in (cut[0], cut[2], cut[3])))
    norm = _kernel_step(cfg, 1, leaves)
    torch.cuda.synchronize()
    assert abs(float(norm) - _exact_norm(leaf.g for leaf in leaves)) <= 1e-6 * float(norm)
    _check_against_plain(cfg, 1, shapes, leaves, norm, p_dtype, card, views=views, on="cpu")


@pytest.mark.cuda
def test_the_norm_is_the_same_bits_in_every_run(card):
    gen = torch.Generator(device=card).manual_seed(4)
    grads = [torch.randn(s, generator=gen, device=card).to(BF16) for s in RAGGED]
    grads += [torch.randn(8_000_003, generator=gen, device=card)]
    runs = [fused.sum_sq(grads, root=root) for root in (True, True, False, False)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[2], runs[3])
    # the root is torch.sqrt of the f32 sum, as a mesh step takes it after
    # its all-reduce: on a world of one both steps clip by the same bits
    assert torch.equal(runs[0], torch.sqrt(runs[2]))


@pytest.mark.cuda
def test_a_caller_norm_runs_the_update_alone(card):
    """A mesh step hands ``apply`` the norm (``sharded_global_norm``, whose
    ``_sum_sq`` is the kernels' without the root): one launch."""
    cfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=0)
    gen = torch.Generator(device=card).manual_seed(5)
    params = ParamTree({"w": torch.randn(64, 48, generator=gen, device=card).to(BF16),
                        "b": torch.randn(48, generator=gen, device=card).to(BF16)})
    grads = {n: torch.randn(p.shape, generator=gen, device=card).to(BF16)
             for n, p in params.named_parameters()}
    sq = opt_lib._sum_sq(grads.values())
    torch.testing.assert_close(sq, opt_lib._sum_sq_plain(grads.values()), rtol=1e-5, atol=0)
    fused.reset_launch_counts()
    tracer = obs.Tracer()
    with obs.tracing(tracer):
        _, _, m = opt_lib.apply(cfg, opt_lib.init(cfg, params), params, grads, torch.sqrt(sq))
    assert fused.launch_counts()["adamw_update"] == 1 and sum(fused.launch_counts().values()) == 1
    assert tracer.counter_totals()["optimizer.fused"] == {"leaves": 2, "elements": 64 * 48 + 48,
                                                          "launches": 1}


@pytest.mark.cuda
def test_apply_on_the_card_refuses_other_moments(card):
    cfg = opt_lib.AdamWConfig(moment_dtype=BF16)
    params = ParamTree({"w": torch.zeros(4, 4, device=card)})
    with pytest.raises(TypeError, match="must be float32"):
        opt_lib.apply(cfg, opt_lib.init(cfg, params), params, {"w": torch.ones(4, 4, device=card)})
