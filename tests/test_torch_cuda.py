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
    # whisper-large-v3: the encoder's 1500 frames (not a multiple of the
    # 128-key tile) and the cross-attention, MHA at Dh 64, not causal
    (1, 20, 20, 1500, 1500, 64, False, None, 0, torch.bfloat16),
    (2, 20, 20, 224, 1500, 64, False, None, 0, torch.bfloat16),
    (1, 12, 2, 1024, 1024, 128, True, None, 0, torch.bfloat16),      # qwen2-vl-2b, group 6
    # f32 at small grids, where the forward splits the keys across blocks
    (1, 4, 2, 1, 333, 128, True, None, 332, torch.float32),          # Sq 1: one row, 6 splits
    (1, 4, 2, 17, 333, 128, True, None, 316, torch.float32),         # Sq 17
]
# head_dim 320 (gemma3-4b): the TMA / wgmma kernels (the forward's 128-row
# q tiles over 48-key tiles; dq's 64-row items whose 48-key tiles the two
# consumers split; dk/dv's 64-key items over 48-row q steps); f32: the
# 3xTF32 kernels (the forward and dq: 64-row blocks, keys split across
# blocks at small grids; dk/dv: 32-key blocks, the group's heads and the
# rows split across blocks at small grids)
D320_CASES = [
    (1, 8, 4, 2048, 2048, 320, True, 1024, 0, torch.bfloat16),       # gemma3 local layer
    (1, 8, 4, 2048, 2048, 320, True, None, 0, torch.bfloat16),       # gemma3 global layer
    (2, 4, 2, 333, 333, 320, True, None, 0, torch.bfloat16),         # ragged
    (1, 4, 2, 200, 1100, 320, True, 700, 900, torch.bfloat16),       # q_offset, window
    (1, 4, 2, 64, 128, 320, False, 16, 100, torch.bfloat16),         # rows that see no key
    (1, 4, 2, 333, 333, 320, True, None, 0, torch.float32),
    (1, 4, 2, 200, 300, 320, False, 64, 50, torch.float32),
    # the edges of the wgmma kernels' tiles at Dh 320
    (1, 4, 2, 270, 270, 320, False, None, 0, torch.bfloat16),        # Skv no multiple of 48 or 64
    (2, 4, 2, 40, 40, 320, True, None, 0, torch.bfloat16),           # Sq < 64
    (1, 6, 6, 256, 256, 320, True, None, 0, torch.bfloat16),         # MHA
    (1, 8, 2, 300, 300, 320, True, None, 0, torch.bfloat16),         # GQA group 4
    (1, 4, 2, 300, 300, 320, True, 50, 0, torch.bfloat16),           # a window ending inside a tile
    # the edges of dq's split items
    (1, 4, 2, 100, 250, 320, True, None, 150, torch.bfloat16),       # Skv no multiple of 48, q_offset
    (1, 4, 2, 65, 65, 320, True, None, 0, torch.bfloat16),           # the last item holds one row
    (1, 4, 2, 256, 256, 320, True, 100, 0, torch.bfloat16),          # windows start inside tiles at items' edges
    # f32 at small grids (the forward's key split)
    (1, 4, 2, 1, 333, 320, True, None, 332, torch.float32),          # Sq 1: one row, 6 splits
    (1, 4, 2, 17, 333, 320, True, None, 316, torch.float32),         # Sq 17
    (1, 4, 2, 64, 128, 320, False, 16, 100, torch.float32),          # rows that see no key
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


# the f32 backward (3xTF32: flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel
# and, where the work is split across blocks, their combines) at every head
# dim; (sms=132) the split each case takes is in the comment
F32_BWD_CASES = [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset
    (1, 4, 4, 200, 200, 16, True, None, 0),       # GQA group 1 (MHA): dk/dv 4 row splits
    (2, 4, 2, 333, 333, 32, True, None, 0),       # group 2: dq 3 key splits, dk/dv 2 heads x 3 rows
    (1, 8, 2, 300, 300, 64, True, 40, 0),         # group 4, a window
    (1, 4, 2, 64, 128, 128, False, 16, 100),      # rows that see no key
    (1, 4, 2, 64, 128, 320, False, 16, 100),      # the same at Dh 320
    (1, 4, 2, 1, 333, 320, True, None, 332),      # Sq 1 over 333 keys: dq 6 key splits
    (1, 4, 2, 17, 333, 320, True, None, 316),     # Sq 17
    (1, 4, 2, 17, 333, 64, True, None, 316),
    # causal at d320_ragged_f32's shape: the first q tile has keys in one of
    # dq's 6 key splits, the last key tile rows in one of dk/dv's 3 row
    # splits; the other splits' blocks have no work
    (1, 4, 2, 333, 333, 320, True, None, 0),
    (1, 8, 4, 260, 260, 320, False, 100, 0),      # group 2, a window, not causal
    (1, 4, 2, 200, 1100, 320, True, 700, 900),    # q_offset and a window
    (2, 12, 4, 256, 256, 128, True, None, 0),     # group 3
    (4, 8, 4, 1024, 1024, 128, True, None, 0),    # one split each: dq and dk/dv write directly
]


# a rank's geometry under sequence parallelism over "model": its Sq = S / n
# queries from q_offset = r S / n over all S keys, so on every rank but the
# last the keys past its last query take no gradient (dK = dV = 0 exactly);
# the first and the last rank (and a middle one), bf16 at Dh 64 / 128 / 320
# (the TMA / wgmma kernels) and f32 (3xTF32, split across blocks), and
# whisper's encoder (not causal)
SP_CASES = [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset, dtype
    (2, 24, 8, 256, 1024, 128, True, None, 0, torch.bfloat16),     # llama3.2-3b, 4 ranks
    (2, 24, 8, 256, 1024, 128, True, None, 768, torch.bfloat16),
    (2, 8, 2, 128, 512, 64, True, None, 0, torch.bfloat16),
    (2, 8, 2, 128, 512, 64, True, None, 256, torch.bfloat16),
    (1, 8, 4, 256, 1024, 320, True, None, 0, torch.bfloat16),      # gemma3-4b's heads
    (1, 8, 4, 256, 1024, 320, True, 200, 256, torch.bfloat16),     # a window across ranks
    (1, 8, 4, 256, 1024, 320, True, None, 768, torch.bfloat16),
    (1, 4, 2, 256, 1024, 128, True, None, 0, torch.float32),
    (1, 4, 2, 256, 1024, 128, True, None, 512, torch.float32),
    (1, 4, 2, 128, 512, 320, True, None, 0, torch.float32),
    (2, 4, 2, 128, 512, 64, True, 100, 384, torch.float32),
    (1, 20, 20, 375, 1500, 64, False, None, 375, torch.bfloat16),  # whisper's encoder
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


@pytest.mark.parametrize("case", D320_CASES)
@pytest.mark.parametrize("layout", ["kernel", "model"])
def test_flash_fwd_and_fwd_lse_at_head_dim_320(card, case, layout):
    *_, causal, window, q_offset, dtype = case
    q, k, v = _inputs(case, layout=layout)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.launch_counts()
    out = fa.flash_attention_fwd(q, k, v, **kw)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert after["flash_fwd"] - before["flash_fwd"] == 1
    assert after["flash_fwd_lse"] - before["flash_fwd_lse"] == 1
    ref, lse_ref = attention_fwd_lse_ref(q, k, v, **kw)
    for got in (out, o):
        assert got.dtype == dtype and got.stride() == q.stride() and torch.isfinite(got).all()
        assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("case", D320_CASES)
@pytest.mark.parametrize("layout", ["kernel", "model"])
def test_flash_bwd_at_head_dim_320(card, case, layout):
    """The Dh-320 backward kernels against the plain backward; each call
    launches both kernels (no fall-back to the plain version) and two calls
    give the same bits (no atomics)."""
    *_, causal, window, q_offset, dtype = case
    q, k, v = _inputs(case, layout=layout)
    do = _inputs(case, seed=1, layout=layout)[0]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    before = fa.launch_counts()
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for got, want in zip(first, attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        scale = max(want.float().abs().max().item(), 1.0)
        assert (got.float() - want.float()).abs().max().item() <= GRAD_REL[dtype] * scale


@pytest.mark.parametrize("case", F32_BWD_CASES)
@pytest.mark.parametrize("layout", ["kernel", "model"])
def test_f32_backward_matches_plain_version_twice(card, case, layout):
    """The 3xTF32 backward kernels against the plain backward at the f32
    tolerances; each call launches both kernels, and two calls give the
    same bits (the splits are summed in one fixed order, no atomics)."""
    *_, causal, window, q_offset = case
    case = (*case, torch.float32)
    q, k, v = _inputs(case, layout=layout)
    do = _inputs(case, seed=1, layout=layout)[0]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    before = fa.launch_counts()
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert after["flash_bwd_dq"] - before["flash_bwd_dq"] == 2
    assert after["flash_bwd_dkv"] - before["flash_bwd_dkv"] == 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for got, want in zip(first, attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.isfinite(got).all()
        scale = max(want.abs().max().item(), 1.0)
        assert (got - want).abs().max().item() <= GRAD_REL[torch.float32] * scale


def test_grad_at_head_dim_320_goes_through_the_kernels(card):
    """ops.flash_attention with a gradient at Dh 320 runs the forward with
    lse and the two backward kernels, and matches autograd of the plain
    version; Dh 48 still raises before any launch."""
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(1, 200, h, 320, generator=g, device="cuda", requires_grad=True)
               for h in (4, 2, 2))
    before = fa.launch_counts()
    out = flash_attention(q, k, v, window=64)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 0, "flash_fwd_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    ref = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), window=64).transpose(1, 2)
    want = torch.autograd.grad(ref, (q, k, v), torch.ones_like(ref))
    for a, b in zip(grads, want):
        assert (a - b).abs().max().item() <= 1e-4
    narrow = [t[..., :48].detach().requires_grad_() for t in (q, k, v)]
    with pytest.raises(ValueError, match="backward"):
        flash_attention(*narrow)
    assert fa.launch_counts() == after


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


def _sp_inputs(case, layout):
    """q, k, v, do of ``case``: in kernel layout, or as the sequence-parallel
    path gives them (q and dO views of (B, Sq, H, Dh); k and v all-gathered
    over the position blocks, views of (Skv, B, Hk, Dh))."""
    B, H, Hk, Sq, Skv, Dh, *_, dtype = case
    g = torch.Generator(device="cuda").manual_seed(7)
    if layout == "kernel":
        shapes = ((B, H, Sq, Dh), (B, Hk, Skv, Dh), (B, Hk, Skv, Dh), (B, H, Sq, Dh))
        return [torch.randn(s, generator=g, device="cuda").to(dtype) for s in shapes]
    q, do = (torch.randn((B, Sq, H, Dh), generator=g, device="cuda").to(dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn((Skv, B, Hk, Dh), generator=g, device="cuda").to(dtype)
            .movedim(0, 1).transpose(1, 2) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("case", SP_CASES)
@pytest.mark.parametrize("layout", ["kernel", "gathered"])
def test_flash_at_a_sequence_parallel_rank_matches_plain_versions(card, case, layout):
    """fwd + lse, dq and dk/dv at a rank's geometry against the plain
    versions; causal, dK and dV are exactly 0 on the keys past the rank's
    last query, and so are the plain versions'."""
    *_, Sq, Skv, Dh, causal, window, q_offset, dtype = case
    q, k, v, do = _sp_inputs(case, layout)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    o_ref, lse_ref = attention_fwd_lse_ref(q, k, v, **kw)
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    for got, want in zip((dq, dk, dv), attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        scale = max(want.float().abs().max().item(), 1.0)
        assert (got.float() - want.float()).abs().max().item() <= GRAD_REL[dtype] * scale
        if causal and got is not dq:
            end = q_offset + Sq
            assert torch.count_nonzero(got[:, :, end:]).item() == 0
            assert torch.count_nonzero(want[:, :, end:]).item() == 0


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


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-vl-2b", "whisper-large-v3"])
def test_gemma3_vlm_whisper_smoke_on_card_match_cpu(card, arch):
    """chip_smoke.py's model phase for the three families: f32, flash on the
    card against the plain path on the CPU, a forward of 2 x 100 positions
    (gemma3-smoke's window of 8 binds; vlm: embeddings at grid positions3;
    whisper: 40 frames) and a fill plus 3 decode steps, within 1e-3; one
    flash_fwd an attention of the forward.  The function fails the process
    (SystemExit) where they disagree."""
    errs, launches = _chip_smoke().family_agreement(arch)
    assert max(errs) <= 1e-3 and launches > 0


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-vl-2b", "whisper-large-v3", "gemma3-d320"])
def test_gemma3_vlm_whisper_train_steps_on_card_match_cpu(card, arch):
    """chip_smoke.py's model phase: two f32 train steps (remat, the flash
    kernels; gemma3-d320 is gemma3-smoke widened to Dh 320, so the Dh-320
    backward kernels) against the plain path on the CPU, same weights and
    batches; the function fails the process (SystemExit) where the
    launches, losses, grad norms or params disagree."""
    smoke = _chip_smoke()
    base = smoke.gemma3_d320_smoke() if arch == "gemma3-d320" else get_smoke_config(arch)
    smoke.family_train_agreement(base)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if get_smoke_config(a).family not in ("vlm", "whisper")])
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
    smoke = _chip_smoke()
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


# the flow-level simulator's kernels (kernels/flow/csrc/flow.cu): trees,
# counts and loads equal to the plain versions on the CPU, bit for bit
FLOW_NETS = [("railx", 8, 2), ("railx", 6, 3), ("torus", 8, 2)]


def _flow_nets(kind, scale, m):
    from repro_torch.core import compiled_flow as cf

    build = cf.build_compiled_railx_hyperx if kind == "railx" else cf.build_compiled_torus2d
    return {dev: build(scale, m, 2.0, device=dev) for dev in ("cuda", "cpu")}


@pytest.mark.parametrize("net", FLOW_NETS, ids=lambda n: f"{n[0]}{n[1]}_m{n[2]}")
def test_flow_kernels_match_the_plain_versions(card, net):
    from repro_torch.core import compiled_flow as cf
    from repro_torch.kernels.flow import flow

    nets = _flow_nets(*net)
    flow.reset_launch_counts()
    got, want = ({dev: f(nets[dev]) for dev in nets} for f in (
        lambda cn: cf.alltoall_edge_counts(cn, batch=37),
        lambda cn: cf.symmetric_alltoall_counts(cn)[1]))
    for d in (got, want):
        assert torch.equal(d["cuda"].cpu(), d["cpu"])
    srcs = nets["cpu"].chips()[:20]
    ok = torch.rand(nets["cpu"].num_edges, generator=torch.Generator().manual_seed(0)) < 0.7
    for edge_ok in (None, ok):
        forest = cf.bfs_forest(nets["cuda"], srcs, None if edge_ok is None else edge_ok.cuda())
        for a, b in zip(forest, cf.bfs_forest(nets["cpu"], srcs, edge_ok)):
            assert torch.equal(a.cpu(), b)
    demands = {(s, t): 1.0 / (1 + s + t) for s in range(0, 40, 7)
               for t in range(nets["cpu"].num_vertices) if t != s}
    for p in (1, 2):
        a, b = (cf.route_demands(nets[dev], demands, p) for dev in ("cuda", "cpu"))
        assert torch.equal(a.cpu().view(torch.int64), b.view(torch.int64))
    assert cf.alltoall_throughput_compiled(nets["cuda"], 8.0) == \
        cf.alltoall_throughput_compiled(nets["cpu"], 8.0)
    assert all(flow.launch_counts().values()), flow.launch_counts()


def _flow_level_case(kind):
    """(network, qs, F, state) on the card for one ``bfs_level`` call of
    level 2 (the frontier at depth 1, other discovered keys at 0): "random"
    a random mid-BFS state of RailX 6 (5 sources, a frontier of every third
    discovered key at queue[7:]); "empty" no frontier; "no_winner" a
    frontier whose out-edges all lead to discovered keys; "star" a hub with
    70 out-edges (more than a warp's lanes, two mask words) as the whole
    frontier of 3 sources."""
    from repro_torch.core import compiled_flow as cf
    from repro_torch.core.simulator import FlowNetwork
    from repro_torch.kernels.flow import ref

    if kind == "star":
        net = FlowNetwork()
        for i in range(70):
            net.add_link("hub", f"x{i}", 1.0)
            net.add_link(f"x{i}", "hub", 1.0)
        cn = cf.CompiledNetwork.from_flow_network(net, device="cuda")
    else:
        cn = cf.build_compiled_railx_hyperx(6, 2, 2.0, device="cuda")
    n = cn.num_vertices
    B = 3 if kind == "star" else 5
    size, qs = B * n, 0 if kind == "star" else 7
    g = torch.Generator(device="cuda").manual_seed(1)
    if kind == "star":
        depth = torch.full((size,), -1, dtype=torch.int32, device="cuda")
        fkeys = torch.arange(B, device="cuda") * n + cn.vertex_id["hub"]
    else:
        depth = torch.where(torch.rand(size, generator=g, device="cuda") < 0.5, -1, 1).int()
        if kind == "no_winner":
            depth.fill_(1)
        depth[depth == 1] = 0
        fkeys = torch.nonzero(depth == 0).flatten()[::3].contiguous()
        if kind == "empty":
            fkeys = fkeys[:0]
    depth[fkeys] = 1
    queue = torch.randint(0, size, (size,), generator=g, device="cuda")
    queue[qs:qs + fkeys.numel()] = fkeys
    rank = torch.full((size,), ref.INF, dtype=torch.int64, device="cuda")
    rank[fkeys] = torch.arange(fkeys.numel(), device="cuda")
    win = torch.where(depth == -1, ref.INF, torch.randint(0, 99, (size,), generator=g,
                                                          device="cuda"))
    state = {"queue": queue, "epos": torch.full((size,), -7, dtype=torch.int64, device="cuda"),
             "child": torch.full((size + 1,), -7, dtype=torch.int64, device="cuda"),
             "rank": rank, "depth": depth, "win": win,
             "info": torch.full((3,), -7, dtype=torch.int64, device="cuda")}
    return cn, qs, fkeys.numel(), state


@pytest.mark.parametrize("kind", ["random", "empty", "no_winner", "star"])
@pytest.mark.parametrize("claim", ["walk", "dense"])
@pytest.mark.parametrize("bottom_up", [False, True], ids=["top_down", "bottom_up"])
def test_flow_bfs_level_both_directions_match_the_plain_version(card, bottom_up, claim, kind):
    """One whole level on the card against the plain version on the same
    state: the new level's keys and edges, the child offsets, depths,
    ranks, ``win``, the size and direction sums, every tensor equal; the
    scratch left zero.  Top-down claims by walking the frontier's edges or
    by one pass over the keys (``frontier_edges`` 0 or B n picks it;
    bottom-up has one claim)."""
    from repro_torch.core import compiled_flow as cf
    from repro_torch.kernels.flow import flow, ref

    cn, qs, F, state = _flow_level_case(kind)
    rev = cf._reverse_tables(cn)
    n, stride = cn.num_vertices, rev.stride
    size = state["depth"].numel()
    ok = None
    if kind == "random":
        ok = torch.rand(cn.num_edges, generator=torch.Generator(device="cuda").manual_seed(2),
                        device="cuda") < 0.8
    out = {}
    for name, fn in (("kernel", flow.bfs_level), ("plain", ref.bfs_level_ref)):
        st = {k: v.clone() for k, v in state.items()}
        scratch = flow.bfs_scratch(size, stride, "cuda")
        fn(bottom_up, 2, st["queue"], st["epos"], st["child"], qs, F, st["rank"], st["depth"],
           st["win"], cn.indptr, cn.nbr, rev.rev_indptr, rev.rev_edge, rev.rev_src, rev.rev_slot,
           rev.deg, ok, size if claim == "dense" else 0, scratch, st["info"], n, stride)
        torch.cuda.synchronize()
        assert not scratch[-(-size // flow.SCAN_TILE):].any()  # the masks, past the tile sums
        out[name] = st
    for k in state:
        assert torch.equal(out["kernel"][k], out["plain"][k]), k
    new = int(out["kernel"]["info"][0])
    if kind in ("empty", "no_winner"):
        assert new == 0 and out["kernel"]["info"].tolist() == [0, 0, 0]
    else:
        assert new > 0
    if kind == "star":
        assert new == 3 * 70 and out["kernel"]["child"][:4].tolist() == [3, 73, 143, -7]


def test_flow_bfs_of_1024_sources_matches_the_plain_version(card):
    """A whole batched BFS of 1,024 sources on RailX 32 m 2 (4,096 chips,
    the exact sweep's batch at 16,384 chips), on the card and through the
    plain versions on the CPU: queue, edges, child offsets, level bounds,
    depths and the level-ordered fold's counts equal."""
    from repro_torch.core import compiled_flow as cf

    nets = {dev: cf.build_compiled_railx_hyperx(32, 2, 2.0, device=dev) for dev in ("cuda", "cpu")}
    forests, counts = {}, {}
    for dev, cn in nets.items():
        f = cf._bfs_levels(cn, cn.chips()[:1024])
        K = torch.zeros(cn.num_edges, dtype=torch.int64, device=dev)
        cf._fold(cn, f, torch.ones(cn.num_vertices, dtype=torch.int64, device=dev), K)
        forests[dev], counts[dev] = f, K.cpu()
    a, b = forests["cuda"], forests["cpu"]
    assert a.bounds == b.bounds and len(a.bounds) > 4
    end = a.bounds[-1]
    assert torch.equal(a.queue[:end].cpu(), b.queue[:end])
    assert torch.equal(a.epos[1024:end].cpu(), b.epos[1024:end])
    assert torch.equal(a.child[:end + 1].cpu(), b.child[:end + 1])
    assert torch.equal(a.depth.cpu(), b.depth)
    assert torch.equal(counts["cuda"], counts["cpu"])


# the orbit gather: the sweep's inputs at steps 1, 2 and 3 and on the torus;
# then synthetic grids whose residues are wider than a block's 1,024 columns
ORBIT_CASES = [("railx", 5, 2), ("railx", 8, 4), ("railx", 6, 3), ("railx", 12, 3),
               ("torus", 8, 2), ("wide", 1), ("wide", 2)]


def _orbit_inputs(case):
    """((C, indptr, R, scale, step, m2), (re_u, re_slot, sx, sy)) on the
    card, C random: the kernel's arguments, and the plain gather's index
    tensors built here from the representative sources and the group."""
    from repro_torch.core import compiled_flow as cf

    g = torch.Generator(device="cuda").manual_seed(3)
    if case[0] == "wide":
        # scale 4, one chip a node; degrees invariant under translations by
        # step, the representative block's 700-1,300 edges a vertex
        step, scale = case[1], 4
        d = {(0, 0): 1500, (0, 1): 900, (1, 0): 1300, (1, 1): 700}
        degs = torch.tensor([d[(X % step, Y % step)] if step == 2 else 1500
                             for X in range(scale) for Y in range(scale)], device="cuda")
        indptr = torch.zeros(scale * scale + 1, dtype=torch.int64, device="cuda")
        torch.cumsum(degs, 0, out=indptr[1:])
        reps = torch.tensor([X * scale + Y for X in range(step) for Y in range(step)],
                            device="cuda")
        sym = cf.TranslationSymmetry(scale, 1, step)
    else:
        build = cf.build_compiled_railx_hyperx if case[0] == "railx" else cf.build_compiled_torus2d
        cn = build(case[1], case[2], 2.0, device="cuda")
        indptr, sym, reps = cn.indptr, cn.symmetry, cf.representative_sources(cn)
    counts = indptr[reps + 1] - indptr[reps]
    re_u = torch.repeat_interleave(reps, counts)
    re_slot = torch.arange(re_u.numel(), device="cuda") - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    C = torch.randint(-2 ** 40, 2 ** 40, (int(indptr[-1]),), generator=g, device="cuda")
    sx, sy = sym.group_elements("cuda")
    return ((C, indptr, re_u.numel(), sym.scale, sym.step, sym.chips_per_node),
            (re_u, re_slot, sx, sy))


@pytest.mark.parametrize("case", ORBIT_CASES, ids=lambda c: "_".join(map(str, c)))
def test_flow_orbit_gather_matches_the_plain_version(card, case):
    """The column-sum kernel against the plain gather on the same inputs,
    integers equal, twice; the wide cases split a residue's columns over
    two blocks (and, at step 2, give the residues different widths)."""
    from repro_torch.kernels.flow import flow, ref

    args, (re_u, re_slot, sx, sy) = _orbit_inputs(case)
    C, indptr, R, scale, step, m2 = args
    want = ref.orbit_gather_ref(C, indptr, re_u, re_slot, sx, sy, scale, m2)
    for _ in range(2):
        got = flow.orbit_gather(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    if case[0] == "wide":
        assert want.numel() > 1024 * (2 if case[1] == 2 else 1)


def _fold_case(kind):
    """(w, off) on the card: "mixed" 2,304 runs of 0-5,000 weights (empty
    runs, runs across the 2,048-element staging buffer and across blocks'
    spans) with values that cancel (1e16, -1e16 among small ones); "one_run"
    one run holding the whole stream between empty runs; "empty" every run
    empty; "single" one edge."""
    g = torch.Generator(device="cuda").manual_seed(4)
    if kind == "mixed":
        lens = torch.randint(0, 200, (2304,), generator=g, device="cuda")
        lens[::97] = 0
        lens[5::301] = torch.randint(2000, 5000, lens[5::301].shape, generator=g, device="cuda")
    else:
        lens = torch.tensor({"one_run": [0, 0, 9000, 0, 0], "empty": [0] * 7,
                             "single": [3000]}[kind], device="cuda")
    off = torch.zeros(lens.numel() + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(lens, 0, out=off[1:])
    L = int(off[-1])
    w = torch.rand(L, generator=g, device="cuda", dtype=torch.float64) * 3 - 1
    big = torch.rand(L, generator=g, device="cuda") < 0.05
    w[big] = torch.where(torch.rand(L, generator=g, device="cuda")[big] < 0.5, 1e16, -1e16).double()
    return w, off


@pytest.mark.parametrize("kind", ["mixed", "one_run", "empty", "single"])
def test_flow_ordered_fold_matches_the_plain_version_bit_for_bit(card, kind):
    """The staged fold against the plain left-to-right fold on the same
    stream: the same bits for every edge, twice."""
    from repro_torch.kernels.flow import flow, ref

    w, off = _fold_case(kind)
    want = ref.ordered_fold_ref(w, off).view(torch.int64)
    for _ in range(2):
        got = flow.ordered_fold(w, off)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int64), want)
    if kind == "one_run":
        assert got[2].item() == ref.ordered_fold_ref(w.cpu(), off.cpu())[2].item()


def test_flow_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.flow import flow

    w = torch.ones(4, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError, match="off must be int64"):
        flow.ordered_fold(w, torch.tensor([0, 2, 4], dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="CUDA device"):
        flow.ordered_fold(w, torch.tensor([0, 2, 4]))
    (C, indptr, R, scale, step, m2), _ = _orbit_inputs(("railx", 8, 4))
    for bad in (dict(R=R - 1), dict(R=R + 1),           # E != (scale / step)^2 R
                dict(indptr=indptr[:-4]),               # not scale^2 m2 vertices
                dict(step=3), dict(step=0)):            # step not dividing scale
        args = dict(C=C, indptr=indptr, R=R, scale=scale, step=step, m2=m2) | bad
        with pytest.raises(ValueError, match=r"E = \(scale / step\)\^2 R"):
            flow.orbit_gather(**args)


# the cluster twin's goodput (cluster/metrics.py estimate_goodput): its job
# network routed through the flow kernels on the card, the same float as on
# the CPU, on each fabric with a job_network
@pytest.mark.parametrize("fabric", ["railx-hyperx", "torus-2d", "torus-3d", "rail-only"])
def test_cluster_goodput_on_the_card_matches_the_cpu(card, fabric):
    from repro_torch.cluster import estimate_goodput, make_job, plan_job_mapping
    from repro_torch.core.availability import JobAllocation
    from repro_torch.core.topology import RailXConfig
    from repro_torch.kernels.flow import flow

    cfg = RailXConfig(m=4, n=4, R=64)
    for arch in ("qwen3-8b", "paper-llama3-moe", "llama3.2-3b"):
        job = make_job(0, arch)
        jm = plan_job_mapping(cfg, job)
        alloc = JobAllocation(tuple(range(jm.rows_req)), tuple(range(1, 1 + jm.cols_req)))
        flow.reset_launch_counts()
        got = estimate_goodput(cfg, job, jm.mapping, alloc, fabric=fabric, device="cuda")
        counts = flow.launch_counts()
        assert counts["flow_bfs_level"] and counts["flow_ordered_fold"], counts
        assert got == estimate_goodput(cfg, job, jm.mapping, alloc, fabric=fabric, device="cpu")
