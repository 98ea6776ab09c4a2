"""The f32 flash backward's host side, on the CPU: how the work of
``flash_bwd_dq_tf32_kernel`` (``flash_attention.f32_key_split``) and of
``flash_bwd_dkv_tf32_kernel`` (``flash_attention.f32_dkv_split``) is split
across blocks, the scratch the wrappers allocate for the partials, and the
kernels' split-and-combine arithmetic emulated in torch, block by block and
step by step at the kernels' boundaries, against the plain backward and
against the Pallas backward in interpret mode."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jfa  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_fwd_lse_ref, attention_mask,
)

SMS = 132  # an H100's SMs

# (B, H, Sq, Skv) -> dq's (splits, keys a split): dq's blocks are the f32
# forward's, 64 q rows over one split of the keys
DQ_SPLITS = [
    ((1, 4, 333, 333), (6, 64)),        # d320_ragged_f32: 24 blocks
    ((1, 8, 2048, 2048), (1, 2048)),    # gemma3_global_f32: 256 blocks fill the card
    ((4, 24, 1024, 1024), (1, 1024)),   # llama_train_f32: 1536 blocks
    ((1, 4, 1, 333), (6, 64)),          # the card tests' Sq 1 and 17 over 333 keys
    ((1, 4, 17, 333), (6, 64)),
]
# (B, Hk, group, Sq, Skv, Dh) -> dk/dv's (head splits, row splits, rows a split)
DKV_SPLITS = [
    ((1, 2, 2, 333, 333, 320), (2, 3, 128)),     # d320_ragged_f32: 11 x 2 blocks of 32 keys
    ((1, 4, 2, 2048, 2048, 320), (1, 1, 2048)),  # gemma3_global_f32: 256 blocks
    ((4, 8, 3, 1024, 1024, 128), (1, 1, 1024)),  # llama_train_f32: 512 blocks of 64 keys
    ((1, 2, 2, 1, 333, 320), (2, 1, 32)),        # Sq 1: one step of rows
    ((1, 2, 2, 17, 333, 128), (2, 1, 32)),       # Sq 17
    ((1, 4, 1, 200, 200, 16), (1, 4, 64)),       # MHA: no head to split
    ((1, 2, 4, 300, 300, 64), (4, 4, 96)),       # group 4
]


@pytest.mark.parametrize("shape, want", DQ_SPLITS)
def test_dq_split_at_the_cards_shapes(shape, want):
    assert fa.f32_key_split(*shape, sms=SMS) == want


@pytest.mark.parametrize("shape, want", DKV_SPLITS)
def test_dkv_split_at_the_cards_shapes(shape, want):
    assert fa.f32_dkv_split(*shape, sms=SMS) == want


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
@pytest.mark.parametrize("shape", [s for s, _ in DQ_SPLITS])
def test_dq_split_covers_the_keys(shape, sms):
    B, H, Sq, Skv = shape
    splits, chunk = fa.f32_key_split(B, H, Sq, Skv, sms)
    assert chunk % fa.F32_CHUNK == 0  # a split starts on a step (32 keys, 16 at Dh 320)
    assert (splits - 1) * chunk < Skv <= splits * chunk
    assert splits == 1 or chunk >= fa.F32_MIN_SPLIT


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
@pytest.mark.parametrize("shape", [s for s, _ in DKV_SPLITS])
def test_dkv_split_covers_the_rows(shape, sms):
    B, Hk, group, Sq, Skv, Dh = shape
    heads, splits, chunk = fa.f32_dkv_split(B, Hk, group, Sq, Skv, Dh, sms)
    blocks = -(-Skv // fa.f32_dkv_keys(Dh)) * Hk * B
    assert chunk % fa.F32_CHUNK == 0  # a split starts on a step (32 rows, 16 at Dh 320)
    assert (splits - 1) * chunk < Sq <= splits * chunk
    assert splits == 1 or chunk >= fa.F32_MIN_SPLIT
    # a block a head of the group only where the key tiles leave SMs idle
    assert heads == (group if blocks < sms else 1)
    assert (splits - 1) * blocks * heads < sms  # no more splits than it takes to fill the card


@pytest.mark.parametrize("Dh, keys", [(16, 64), (64, 64), (128, 64), (320, 32)])
def test_dkv_block_keys(Dh, keys):
    assert fa.f32_dkv_keys(Dh) == keys


def test_backward_scratch():
    # dq: each key split's partial dq; none for one split
    assert fa.f32_dq_scratch(1, 1, 8, 2048, 320) == 0
    assert fa.f32_dq_scratch(6, 1, 4, 333, 320) == 6 * 4 * 333 * 320
    # dk/dv: each (row split, head split)'s partial dk and dv
    assert fa.f32_dkv_scratch(1, 1, 4, 8, 1024, 128) == 0
    assert fa.f32_dkv_scratch(2, 3, 1, 2, 333, 320) == 2 * 2 * 3 * 2 * 333 * 320
    assert fa.f32_dkv_scratch(2, 1, 1, 2, 333, 320) == 2 * 2 * 2 * 333 * 320


# The kernels' ranges (flash_common.cuh key_range, flash_bwd.cu query_range,
# dq_split_keys and dkv_split_rows), and their steps: dq 32 keys (16 at Dh
# 320) over 64-row blocks; dk/dv 32 rows (16 at Dh 320) over tiles of 64
# keys (32 at Dh 320).


def _steps(Dh):
    return (16, 16, 32) if Dh > 128 else (32, 32, 64)  # dq keys, dk/dv rows, dk/dv keys


def _sees_no_key(qpos, Skv, window):
    return window is not None and qpos - window + 1 >= Skv


def _key_range(Skv, causal, window, q_offset, r0, r1):
    qmin, qmax = r0 + q_offset, r1 - 1 + q_offset
    if _sees_no_key(qmax, Skv, window):
        return 0, Skv  # the last row sees no key: every key
    lo = max(0, qmin - window + 1) if window is not None else 0
    return lo, (min(Skv, qmax + 1) if causal else Skv)


def _query_range(Sq, Skv, causal, window, q_offset, n0, n1):
    lo = max(0, n0 - q_offset) if causal else 0
    # rows that see no key at all (the last ones) take p = 1/Skv on every key
    if window is not None and not _sees_no_key(Sq - 1 + q_offset, Skv, window):
        return lo, min(Sq, n1 - 1 + window - q_offset)
    return lo, Sq


def _check_unmasked(mask, Skv, causal, window, q_offset, r0, r1, n0, n):
    """flash_common.cuh tile_needs_mask: where it says a tile of rows [r0,
    r1) and keys [n0, n0 + n) needs no mask, the kernels take every pair of
    it as visible; check that they are."""
    qmin, qmax = r0 + q_offset, r1 - 1 + q_offset
    needs = (n0 + n > Skv or (causal and n0 + n - 1 > qmin)
             or (window is not None and n0 <= qmax - window))
    assert needs or bool(mask[r0:r1, n0:n0 + n].all())


def _cut(lo, hi, step, s, chunk):
    """A range from a multiple of ``step``, cut to split s of ``chunk``."""
    return max(lo // step * step, s * chunk), min(hi, (s + 1) * chunk)


def _pairs(q, k, v, o, lse, do, causal, window, q_offset):
    """What the kernels form on the fragments, over every (row, key) pair in
    f64, kv heads expanded to H: P (1/Skv over every key of a row that sees
    none), dS (0 off the visible pairs), and k, v, q, do."""
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    f = torch.float64
    ke, ve = (t.to(f).repeat_interleave(H // Hk, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f), ke) * Dh ** -0.5
    mask = attention_mask(Sq, Skv, causal, window, q_offset)
    no_key = ~mask.any(-1, keepdim=True)
    lse = lse.to(f)[..., None]
    p = torch.where(mask, torch.exp(s - lse), torch.where(no_key, torch.exp(-lse), 0.0))
    delta = (o.to(f) * do.to(f)).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (torch.einsum("bhqd,bhkd->bhqk", do.to(f), ve) - delta), 0.0)
    return p, ds, ke, q.to(f), do.to(f)


def _emulate_dq(q, k, v, o, lse, do, *, causal, window, q_offset, splits, chunk):
    """flash_bwd_dq_tf32_kernel and its combine: each 64-row block's key
    splits, each a sum over its steps of dS K (a step's keys past the
    split's end belong to no row of the block, and dS is 0 there), scaled;
    then the splits that hold keys, in split order."""
    B, H, Sq, Dh = q.shape
    Skv = k.shape[2]
    step = _steps(Dh)[0]
    _, ds, ke, _, _ = _pairs(q, k, v, o, lse, do, causal, window, q_offset)
    mask = attention_mask(Sq, Skv, causal, window, q_offset)
    dq = torch.zeros(B, H, Sq, Dh, dtype=torch.float64)
    empty = 0
    for r0 in range(0, Sq, fa.F32_ROWS):
        r1 = min(Sq, r0 + fa.F32_ROWS)
        k_lo, k_hi = _key_range(Skv, causal, window, q_offset, r0, r1)
        for s in range(splits):
            lo, hi = _cut(k_lo, k_hi, step, s, chunk)
            if lo >= hi:
                empty += 1
                continue
            part = torch.zeros(B, H, r1 - r0, Dh, dtype=torch.float64)
            for n0 in range(lo, hi, step):
                n1 = min(Skv, n0 + step)  # keys past Skv load as zeros
                _check_unmasked(mask, Skv, causal, window, q_offset, r0, r1, n0, step)
                part += ds[:, :, r0:r1, n0:n1] @ ke[:, :, n0:n1]
            dq[:, :, r0:r1] += part * Dh ** -0.5
    return dq, empty


def _emulate_dkv(q, k, v, o, lse, do, *, causal, window, q_offset, heads, splits, chunk):
    """flash_bwd_dkv_tf32_kernel and its combine: each key tile's row splits,
    each over every head of the group in turn (``heads`` 1) or one head a
    partial, a sum over its steps of P^T dO and dS^T Q (rows past a split's
    end see none of the tile's keys); then the partials in (row split, head
    split) order."""
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    group = H // Hk
    _, rows, keys = _steps(Dh)
    p, ds, _, qf, dof = _pairs(q, k, v, o, lse, do, causal, window, q_offset)
    mask = attention_mask(Sq, Skv, causal, window, q_offset)
    dk = torch.zeros(B, Hk, Skv, Dh, dtype=torch.float64)
    dv = torch.zeros_like(dk)
    empty = 0
    for n0 in range(0, Skv, keys):
        n1 = min(Skv, n0 + keys)
        q_lo, q_hi = _query_range(Sq, Skv, causal, window, q_offset, n0, n1)
        for s in range(splits):
            lo, hi = _cut(q_lo, q_hi, rows, s, chunk)
            if lo >= hi:
                empty += 1
                continue
            for hs in range(heads):
                walk = range(group) if heads == 1 else [hs]
                pk = torch.zeros(B, Hk, n1 - n0, Dh, dtype=torch.float64)
                pv = torch.zeros_like(pk)
                for g in walk:
                    hsel = torch.arange(Hk) * group + g
                    for r0 in range(lo, hi, rows):
                        r1 = min(Sq, r0 + rows)  # rows past Sq load as zeros
                        _check_unmasked(mask, Skv, causal, window, q_offset, r0, r1, n0, keys)
                        pt = p[:, hsel, r0:r1, n0:n1].transpose(-1, -2)
                        dst = ds[:, hsel, r0:r1, n0:n1].transpose(-1, -2)
                        pv += pt @ dof[:, hsel, r0:r1]
                        pk += dst @ qf[:, hsel, r0:r1]
                dk[:, :, n0:n1] += pk * Dh ** -0.5
                dv[:, :, n0:n1] += pv
    return dk, dv, empty


def _case_inputs(B, H, Hk, Sq, Skv, Dh, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, h, S, Dh, generator=g)
            for h, S in ((H, Sq), (Hk, Skv), (Hk, Skv), (H, Sq))]


def _emulate(q, k, v, do, kw, sms=SMS):
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    o, lse = attention_fwd_lse_ref(q, k, v, **kw)
    splits, chunk = fa.f32_key_split(B, H, Sq, Skv, sms)
    heads, rsplits, rchunk = fa.f32_dkv_split(B, Hk, H // Hk, Sq, Skv, Dh, sms)
    dq, dq_empty = _emulate_dq(q, k, v, o, lse, do, splits=splits, chunk=chunk, **kw)
    dk, dv, dkv_empty = _emulate_dkv(q, k, v, o, lse, do, heads=heads, splits=rsplits,
                                     chunk=rchunk, **kw)
    return (dq, dk, dv), (o, lse), (splits, heads * rsplits), (dq_empty, dkv_empty)


def _rel_err(got, want):
    want = want.double()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()


# the cases of test_torch_flash_tma.py::test_f32_split_and_combine_give_the_plain_forward,
# and one at Dh 320, whose steps and blocks are narrower
SPLIT_CASES = [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset
    (1, 4, 2, 333, 333, 16, True, None, 0),     # d320_ragged_f32's geometry
    (1, 4, 2, 200, 300, 16, False, 64, 50),     # a window, Sq != Skv
    (1, 4, 2, 64, 128, 16, False, 16, 100),     # rows that see no key
    (2, 2, 1, 128, 128, 32, True, 8, 0),        # gemma3-smoke's window of 8
    (1, 4, 2, 17, 128, 16, True, None, 111),    # Sq 17 at the end of the keys
    (1, 4, 2, 1, 333, 16, True, None, 332),     # Sq 1: one row over every split
    (1, 4, 2, 100, 150, 320, True, None, 50),   # Dh 320: 16-key / 16-row steps, 32-key tiles
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_f32_backward_split_and_combine_give_the_plain_backward(case):
    B, H, Hk, Sq, Skv, Dh, causal, window, q_offset = case
    q, k, v, do = _case_inputs(B, H, Hk, Sq, Skv, Dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got, (o, lse), (dq_parts, dkv_parts), _ = _emulate(q, k, v, do, kw)
    assert dq_parts > 1 and dkv_parts > 1  # each case splits both kernels' work
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= 1e-5, name


def test_splits_leave_blocks_with_no_work():
    """At d320_ragged_f32's geometry the causal mask leaves the first q tile
    keys in the first split only, and the last key tile rows in the last row
    split only: those blocks return at once, and the combines skip them."""
    q, k, v, do = _case_inputs(1, 4, 2, 333, 333, 16)
    kw = dict(causal=True, window=None, q_offset=0)
    *_, (dq_empty, dkv_empty) = _emulate(q, k, v, do, kw)
    assert dq_empty > 0 and dkv_empty > 0


def test_one_split_each_gives_the_plain_backward():
    # a card with many SMs' worth of blocks: dq and dk/dv write directly
    case = (1, 4, 2, 200, 200, 32, True, 40, 0)
    B, H, Hk, Sq, Skv, Dh, causal, window, q_offset = case
    q, k, v, do = _case_inputs(B, H, Hk, Sq, Skv, Dh, seed=3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got, (o, lse), parts, _ = _emulate(q, k, v, do, kw, sms=1)
    assert parts == (1, 1)
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        assert _rel_err(g, w) <= 1e-5


# against the Pallas backward (its blocks of 128 need Sq and Skv multiples of
# min(128, S), and rows that each see a key)
PALLAS_CASES = [
    (1, 4, 2, 128, 256, 32, True, None, 128),
    (1, 2, 1, 256, 256, 64, True, 64, 0),
    (1, 2, 1, 128, 128, 320, True, None, 0),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_f32_backward_split_and_combine_match_jax_pallas_interpret(case):
    B, H, Hk, Sq, Skv, Dh, causal, window, q_offset = case
    rng = np.random.RandomState(4)
    arrs = [rng.randn(B, H, Sq, Dh), rng.randn(B, Hk, Skv, Dh), rng.randn(B, Hk, Skv, Dh),
            rng.randn(B, H, Sq, Dh)]
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.float32) for a in arrs)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jo, jlse = jfa.flash_attention_fwd_lse(jq, jk, jv, **kw, interpret=True)
    want = jfa.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, **kw, interpret=True)
    q, k, v, do = (torch.from_numpy(np.asarray(a, np.float32)) for a in arrs)
    got, *_ = _emulate(q, k, v, do, kw)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        # f32 on the Pallas side, sums in another order (test_torch_flash_backward.TOL)
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5 * scale, rtol=0)
