"""Tests of the port that need a CUDA card: the hand-written kernels against
their plain versions, on the card (flash attention, the SSD scan, the
chunkwise mLSTM), the smoke models on the card against the CPU, and the
collectives on a world of one through NCCL.  They skip elsewhere.

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_fwd_lse_ref, attention_ref,
)
from repro_torch.kernels.mlstm import mlstm as mlstm_mod  # noqa: E402
from repro_torch.kernels.mlstm.ref import mlstm_chunked_ref, mlstm_ref  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

# abs tolerance on unit-variance inputs: bf16 rounds probabilities and the
# output (one ulp is 2^-6 at |x| in [2, 4)); f32 differs in sum order only
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# gradients, relative to the largest |value| of the plain version: bf16 rounds
# P and dS as mma operands and the output; dk/dv sum Sq x group such terms
GRAD_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

CASES = [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset, dtype
    (2, 8, 2, 256, 256, 128, True, None, 0, torch.bfloat16),
    (1, 4, 2, 1000, 1000, 128, True, None, 0, torch.bfloat16),       # ragged
    (1, 4, 2, 512, 512, 64, True, 96, 0, torch.bfloat16),            # window
    (1, 4, 2, 64, 1024, 128, True, None, 960, torch.bfloat16),       # q_offset
    (1, 8, 1, 300, 300, 128, True, None, 0, torch.bfloat16),         # MQA
    (2, 4, 4, 200, 130, 32, False, None, 0, torch.bfloat16),         # non-causal
    (2, 4, 2, 100, 100, 16, True, None, 0, torch.bfloat16),
    (2, 4, 2, 333, 333, 128, True, None, 0, torch.float32),
    (1, 4, 2, 256, 256, 64, True, 40, 0, torch.float32),
    (1, 4, 2, 64, 128, 64, False, 16, 100, torch.bfloat16),          # rows that see no key
    (1, 4, 2, 64, 128, 32, False, 16, 100, torch.float32),
    # bf16 at Dh 64 and 128 runs the TMA / wgmma kernel: 128-row q tiles
    (2, 4, 2, 130, 130, 128, True, None, 0, torch.bfloat16),         # a last tile of 2 rows
    (2, 4, 2, 333, 333, 64, True, None, 0, torch.bfloat16),          # ragged at Dh 64
    (1, 6, 2, 1024, 1024, 128, True, 200, 0, torch.bfloat16),        # window of 200
    (1, 6, 2, 256, 256, 128, True, None, 0, torch.bfloat16),         # GQA group 3
    (1, 8, 1, 200, 200, 64, True, None, 0, torch.bfloat16),          # MQA at Dh 64
    (1, 4, 2, 64, 128, 128, False, 16, 100, torch.bfloat16),         # no key at Dh 128
    # edges of the TMA / wgmma backward's tiles (128-row dq items, 128-key
    # dk/dv items walking 64-row q steps)
    (2, 4, 2, 256, 256, 128, False, None, 0, torch.bfloat16),        # non-causal at Dh 128
    (1, 4, 2, 200, 333, 64, False, None, 0, torch.bfloat16),         # non-causal, Sq != Skv
    (1, 4, 2, 64, 320, 64, True, None, 256, torch.bfloat16),         # Sq < one tile, q_offset
    (1, 12, 2, 256, 256, 128, True, None, 0, torch.bfloat16),        # GQA group 6
]
# q/k/v as the transposed views of (B, S, H, Dh) that ops.flash_attention
# passes (rows H * Dh apart): the serving prefill shape, moonshot's MHA
# prefill and training shape, a ragged one
MODEL_LAYOUT_CASES = [
    (4, 24, 8, 1024, 1024, 128, True, None, 0, torch.bfloat16),
    (4, 16, 16, 1024, 1024, 128, True, None, 0, torch.bfloat16),
    (2, 8, 4, 1000, 1000, 128, True, None, 0, torch.bfloat16),
    (2, 8, 2, 333, 333, 64, True, 100, 0, torch.bfloat16),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, seed=0, layout="kernel"):
    B, H, Hk, Sq, Skv, Dh, *_, dtype = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "model":
        return [torch.randn(s, generator=g, device="cuda").to(dtype).transpose(1, 2)
                for s in ((B, Sq, H, Dh), (B, Skv, Hk, Dh), (B, Skv, Hk, Dh))]
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((B, H, Sq, Dh), (B, Hk, Skv, Dh), (B, Hk, Skv, Dh))]


@pytest.mark.parametrize("case", CASES)
def test_flash_fwd_matches_plain_version(card, case):
    *_, causal, window, q_offset, dtype = case
    q, k, v = _inputs(case)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.LAUNCHES
    out = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all()
    ref = attention_ref(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("case", MODEL_LAYOUT_CASES)
def test_flash_fwd_and_fwd_lse_take_model_layout_views(card, case):
    *_, causal, window, q_offset, dtype = case
    q, k, v = _inputs(case, layout="model")
    assert q.stride(2) == q.shape[1] * q.shape[3]  # rows H * Dh apart
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = fa.flash_attention_fwd(q, k, v, **kw)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    ref, lse_ref = attention_fwd_lse_ref(q, k, v, **kw)
    for got in (out, o):
        assert got.stride() == q.stride() and torch.isfinite(got).all()
        assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_model_layout_takes_strided_views(card):
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 128, 8, 64, generator=g, device="cuda").bfloat16()
    k = torch.randn(2, 128, 2, 64, generator=g, device="cuda").bfloat16()
    v = torch.randn(2, 128, 2, 64, generator=g, device="cuda").bfloat16()
    out = flash_attention(q, k, v)
    assert out.is_contiguous()
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("case", CASES)
def test_flash_fwd_lse_and_bwd_match_plain_versions(card, case):
    *_, causal, window, q_offset, dtype = case
    q, k, v = _inputs(case)
    do = _inputs(case, seed=1)[0]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.launch_counts()
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 0, "flash_fwd_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    o_ref, lse_ref = attention_fwd_lse_ref(q, k, v, **kw)
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    assert lse.dtype == torch.float32 and (lse - lse_ref).abs().max().item() <= 1e-3
    for got, want in zip((dq, dk, dv), attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        scale = max(want.float().abs().max().item(), 1.0)
        assert (got.float() - want.float()).abs().max().item() <= GRAD_REL[dtype] * scale


@pytest.mark.parametrize("case", MODEL_LAYOUT_CASES)
def test_flash_bwd_takes_model_layout_views(card, case):
    """q, k, v and do all transposed views of (B, S, H, Dh), as the model's
    backward passes them."""
    *_, causal, window, q_offset, dtype = case
    q, k, v = _inputs(case, layout="model")
    do = _inputs(case, seed=1, layout="model")[0]
    assert do.stride(2) == do.shape[1] * do.shape[3]  # rows H * Dh apart
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, want in zip(got, attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert g.shape == want.shape and torch.isfinite(g).all()
        scale = max(want.float().abs().max().item(), 1.0)
        assert (g.float() - want.float()).abs().max().item() <= GRAD_REL[dtype] * scale


def test_flash_bwd_gives_the_same_bits_twice(card):
    """No atomics: every sum of the backward kernels has one order."""
    case = (2, 24, 8, 512, 512, 128, True, None, 0, torch.bfloat16)
    q, k, v = _inputs(case)
    do = _inputs(case, seed=1)[0]
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_grad_through_the_kernels_matches_autograd_of_the_plain_version(card):
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(2, 128, h, 64, generator=g, device="cuda", requires_grad=True)
               for h in (8, 2, 2))
    before = fa.launch_counts()
    out = flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    after = fa.launch_counts()
    assert after["flash_fwd_lse"] - before["flash_fwd_lse"] == 1
    assert after["flash_bwd_dkv"] - before["flash_bwd_dkv"] == 1
    ref = attention_ref(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    want = torch.autograd.grad(ref, (q, k, v), torch.ones_like(ref))
    for a, b in zip(grads, want):
        assert (a - b).abs().max().item() <= 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q = torch.randn(1, 2, 64, 64, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q[..., :48].contiguous(), q[..., :48].contiguous(),
                               q[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.randn(1, 2, 64, 128, device="cuda")[..., ::2]
        fa.flash_attention_fwd(t, t, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_on_card_matches_cpu(card, arch):
    """Flash kernel on the card vs the plain path on the CPU, same weights."""
    cpu_zoo = get_model(get_smoke_config(arch))
    gpu_zoo = get_model(dataclasses.replace(get_smoke_config(arch), attn_impl="flash"))
    params = cpu_zoo.init(0, device="cpu")
    gpu_params = ParamTree.from_state_dict({k: v.cuda() for k, v in params.state_dict().items()})
    tokens = torch.randint(0, cpu_zoo.cfg.vocab, (2, 70), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want, _ = cpu_zoo.forward(params, {"tokens": tokens})
        got, _ = gpu_zoo.forward(gpu_params, {"tokens": tokens.cuda()})
    assert (got.cpu() - want).abs().max().item() <= 1e-3


def test_moe_smoke_on_card_matches_cpu(card):
    """moonshot-smoke in f32 (chip_smoke.py's model phase): the card (flash,
    remat) against the CPU with the same weights: the same expert choices
    (recorded by chip_smoke.routing_choices), logits and aux of a forward and
    of 3 decode steps, then two train steps' loss, aux and grad_norm."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    cpu_zoo = get_model(cfg)
    gpu_zoo = get_model(dataclasses.replace(cfg, attn_impl="flash", remat=True))
    params = cpu_zoo.init(0, device="cpu")
    state = params.state_dict()
    gpu_params = ParamTree.from_state_dict({k: v.cuda() for k, v in state.items()})
    tokens = torch.randint(0, cfg.vocab, (2, 70), generator=torch.Generator().manual_seed(0))
    def run(zoo, p, dev):
        logits, aux = zoo.forward(p, {"tokens": tokens.to(dev)})
        cache, steps = zoo.init_cache(2, 8, device=dev), []
        for t in range(3):
            step, cache = zoo.decode_step(p, cache, {"tokens": tokens[:, t:t + 1].to(dev)})
            steps.append(step.cpu())
        return logits.cpu(), aux.item(), steps

    with torch.inference_mode(), smoke.routing_choices() as choices:
        want, want_aux, want_dec = run(cpu_zoo, params, "cpu")
        got, got_aux, got_dec = run(gpu_zoo, gpu_params, "cuda")
    calls = cfg.num_layers * 4  # a forward and 3 decode steps a side
    assert len(choices) == 2 * calls
    assert all(torch.equal(a, b.cpu()) for a, b in zip(choices[:calls], choices[calls:]))
    assert (got - want).abs().max().item() <= 1e-3
    assert abs(got_aux - want_aux) <= 1e-5 * want_aux
    assert max((a - b).abs().max().item() for a, b in zip(got_dec, want_dec)) <= 1e-3
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    rng = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=rng),
                "targets": torch.randint(0, cfg.vocab, (2, 64), generator=rng)} for _ in range(2)]
    out = {}
    for dev, zoo in (("cuda", gpu_zoo), ("cpu", cpu_zoo)):
        p = ParamTree.from_state_dict({k: v.to(dev).clone() for k, v in state.items()},
                                      requires_grad=True)
        step_fn = make_train_step(zoo, ocfg, device=dev)
        opt = opt_lib.init(ocfg, p)
        out[dev] = []
        for b in batches:
            p, opt, m = step_fn(p, opt, b)
            out[dev].append([float(m[k]) for k in ("loss", "aux", "grad_norm")])
    torch.testing.assert_close(torch.tensor(out["cuda"]), torch.tensor(out["cpu"]),
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_smoke_train_step_on_card_matches_cpu(card, remat):
    """Two f32 AdamW steps of the llama smoke config: flash kernels on the
    card vs the plain path on the CPU, same weights and batches."""
    cfg = get_smoke_config("llama3.2-3b")
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = get_model(cfg).init(0, device="cpu").state_dict()
    rng = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=rng),
                "targets": torch.randint(0, cfg.vocab, (2, 64), generator=rng)} for _ in range(2)]
    out = {}
    for dev, c in (("cuda", dataclasses.replace(cfg, attn_impl="flash", remat=remat)),
                   ("cpu", cfg)):
        params = ParamTree.from_state_dict({k: v.to(dev).clone() for k, v in state.items()},
                                           requires_grad=True)
        step_fn = make_train_step(get_model(c), ocfg, device=dev)
        opt = opt_lib.init(ocfg, params)
        before = fa.launch_counts()["flash_bwd_dq"]
        losses = []
        for b in batches:
            params, opt, m = step_fn(params, opt, b)
            losses.append(float(m["loss"]))
        out[dev] = (params.state_dict(), losses, fa.launch_counts()["flash_bwd_dq"] - before)
    assert out["cuda"][2] == 2 * cfg.num_layers and out["cpu"][2] == 0
    torch.testing.assert_close(torch.tensor(out["cuda"][1]), torch.tensor(out["cpu"][1]),
                               rtol=1e-5, atol=0)
    # f32 grads agree to ~1e-6 relative; an element whose grad is near zero
    # may take a fraction of a different AdamW step (lr = 1e-3)
    diff = torch.cat([(v.cpu() - out["cpu"][0][k]).abs().flatten()
                      for k, v in out["cuda"][0].items()])
    assert diff.max().item() <= 1e-4
    assert (diff <= 1e-6).float().mean().item() >= 0.999


# the reference tests' shapes (tests/test_kernels.py), both chunk sizes, and
# the model paths' shapes: zamba2 (H 112, P = N = 64), its smoke config
# (P = N = 16), xlstm-125m (D = 192) and its smoke config (D = 32); then the
# widened ranges (SSD: chunk up to 256, P and N up to 128, the Pallas
# kernel's documented range; mLSTM: D up to 256, chunk up to 256) and rows
# that are not 16-byte aligned (P, N or D not a multiple of 4)
SSD_CASES = [(2, 128, 3, 32, 16, 32), (1, 64, 2, 64, 64, 64), (2, 256, 1, 16, 8, 64),
             (4, 256, 112, 64, 64, 64), (2, 128, 8, 16, 16, 64), (1, 96, 2, 64, 64, 32),
             (2, 512, 8, 128, 128, 128), (2, 512, 16, 64, 64, 256), (1, 512, 2, 128, 128, 256),
             (1, 256, 3, 96, 80, 128), (1, 40, 2, 6, 5, 40)]
MLSTM_CASES = [(2, 128, 2, 32, 32), (1, 64, 3, 16, 64), (2, 256, 1, 64, 64),
               (2, 256, 4, 192, 64), (2, 128, 2, 32, 64), (1, 96, 2, 96, 32),
               (2, 256, 2, 256, 128), (2, 512, 2, 192, 256), (1, 40, 2, 10, 40)]
# relative to the largest |y|: against the sequential oracle, the reference
# tests' own bounds; against the chunked plain version, 1e-4: the same
# chunked function in f32, summed in other orders (and the mLSTM's q.n_t
# taken as a row sum of w o q k^T), carried over up to 8 chunks
SSD_REL, MLSTM_REL, SAME_FORM_REL = 1e-4, 1e-3, 1e-4


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-6)).item()


def _ssd_inputs(B, S, H, P, N, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    return r(B, S, H, P), r(B, S, H).abs() * 0.1 + 0.01, r(B, S, N), r(B, S, N), -(r(H).abs() + 0.5)


def _mlstm_inputs(B, S, H, D, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    return (r(B, S, H, D) / D ** 0.5, r(B, S, H, D), r(B, S, H, D), r(B, S, H),
            torch.nn.functional.logsigmoid(r(B, S, H) + 2))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_fwd_matches_plain_versions(card, case):
    *shape, chunk = case
    x = _ssd_inputs(*shape)
    before = ssd_mod.LAUNCHES
    y = ssd_mod.ssd_fwd(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.LAUNCHES == before + 1
    assert y.shape == x[0].shape and y.dtype == torch.float32 and torch.isfinite(y).all()
    assert _rel(y, ssd_chunked_ref(*x, chunk)[0]) <= SAME_FORM_REL
    if shape[1] <= 128:  # the sequential oracle loops over S
        assert _rel(y, ssd_ref(*x)) <= SSD_REL


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_fwd_matches_plain_versions(card, case):
    *shape, chunk = case
    x = _mlstm_inputs(*shape)
    before = mlstm_mod.LAUNCHES
    y = mlstm_mod.mlstm_fwd(*x, chunk=chunk)
    torch.cuda.synchronize()
    assert mlstm_mod.LAUNCHES == before + 1
    assert y.shape == x[0].shape and y.dtype == torch.float32 and torch.isfinite(y).all()
    assert _rel(y, mlstm_chunked_ref(*x, chunk)) <= SAME_FORM_REL
    if shape[1] <= 128:
        assert _rel(y, mlstm_ref(*x)) <= MLSTM_REL


# an input gate of -1e30 on some rows (B, S, H, D, chunk, rows): a whole tile
# of padding before any real row, the model's padding at the end, scattered
# rows, and a sequence that is all padding
MLSTM_PAD_CASES = [(1, 192, 2, 32, 64, slice(0, 64)), (2, 128, 2, 64, 32, slice(88, 128)),
                   (1, 256, 2, 192, 64, slice(3, 256, 7)), (1, 128, 1, 32, 64, slice(0, 128))]


@pytest.mark.parametrize("case", MLSTM_PAD_CASES)
def test_mlstm_fwd_keeps_the_padding_sentinel(card, case):
    *shape, chunk, rows = case
    q, k, v, ig, lf = _mlstm_inputs(*shape)
    ig[:, rows] = -1e30
    y = mlstm_mod.mlstm_fwd(q, k, v, ig, lf, chunk=chunk)
    torch.cuda.synchronize()
    want = mlstm_chunked_ref(q, k, v, ig, lf, chunk)
    assert torch.isfinite(y).all() and torch.isfinite(want).all()
    assert _rel(y, want) <= SAME_FORM_REL
    assert _rel(y, mlstm_ref(q, k, v, ig, lf)) <= MLSTM_REL


def test_scan_wrappers_reject_what_the_kernels_do_not_take(card):
    x = _ssd_inputs(1, 64, 2, 16, 16)
    with pytest.raises(TypeError):
        ssd_mod.ssd_fwd(*(t.bfloat16() for t in x))
    # chunk up to 256, P and N up to 128 are taken (SSD_CASES); past them not
    with pytest.raises(ValueError, match="P and N up to 128"):
        ssd_mod.ssd_fwd(*_ssd_inputs(1, 64, 2, 256, 16))
    with pytest.raises(ValueError, match="P and N up to 128"):
        ssd_mod.ssd_fwd(*_ssd_inputs(1, 64, 2, 16, 256))
    with pytest.raises(ValueError, match="chunk up to 256"):
        ssd_mod.ssd_fwd(*_ssd_inputs(1, 512, 2, 16, 16), chunk=512)
    with pytest.raises(TypeError):
        mlstm_mod.mlstm_fwd(*(t.bfloat16() for t in _mlstm_inputs(1, 64, 1, 32)))
    with pytest.raises(ValueError, match="D up to 256"):
        mlstm_mod.mlstm_fwd(*_mlstm_inputs(1, 64, 1, 320))
    with pytest.raises(ValueError, match="chunk up to 256"):
        mlstm_mod.mlstm_fwd(*_mlstm_inputs(1, 512, 1, 32), chunk=512)


def test_hierarchical_all_reduce_on_a_world_of_one_nccl_mesh(card):
    """The Eq. 8 schedule and the byte ledger through NCCL on the card: one
    rank, so each collective returns its input, and the ledger holds V for
    each phase (the reduce-scatter over one rank keeps all of V)."""
    import torch.distributed as dist

    from repro_torch.collectives import byte_ledger, flat_all_reduce, hierarchical_all_reduce
    from repro_torch.launch.mesh import free_port, make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
        assert dist.get_backend() == "nccl"
        x = torch.randn(4096, 3, device="cuda").to(torch.bfloat16)
        with byte_ledger() as ledger:
            hier = hierarchical_all_reduce(x, mesh, "data", "pod")
            flat = flat_all_reduce(x, mesh, ("pod", "data"))
        assert hier.is_cuda and hier.dtype == torch.bfloat16
        assert torch.equal(hier, x) and torch.equal(flat, x)
        v = x.numel() * x.element_size()
        assert [(r.op, r.axes, r.nbytes) for r in ledger.records] == [
            ("reduce_scatter", ("data",), v), ("all_reduce", ("pod",), v),
            ("all_gather", ("data",), v), ("all_reduce", ("pod", "data"), v)]
    finally:
        dist.destroy_process_group()
