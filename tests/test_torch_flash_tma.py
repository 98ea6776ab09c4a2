"""The host side of the TMA flash-attention kernels, on the CPU: the tensor
maps' geometry that the wrappers compute and the C side encodes
(``flash_attention.tma_map_geometry``), for the layouts the kernels take,
and what they refuse; and the f32 forward's key split
(``flash_attention.f32_key_split``), with its arithmetic emulated in torch
against the plain version."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402


def _kernel_layout(B, H, S, Dh, layout):
    """A bf16 (B, H, S, Dh) tensor: contiguous, or the transposed view of a
    (B, S, H, Dh) tensor that ``ops.flash_attention`` passes."""
    if layout == "model":
        return torch.zeros(B, S, H, Dh, dtype=torch.bfloat16).transpose(1, 2)
    return torch.zeros(B, H, S, Dh, dtype=torch.bfloat16)


SHAPES = [
    # B, H, Hk, Sq, Skv, Dh
    (4, 24, 8, 1024, 1024, 128),   # llama3.2-3b serving prefill
    (2, 4, 2, 1000, 1000, 128),    # ragged last tile
    (2, 4, 2, 130, 130, 128),      # a last tile of 2 rows
    (2, 4, 2, 333, 333, 64),
    (2, 24, 8, 64, 1024, 128),     # Sq < the 128-row q box
    (1, 48, 1, 512, 512, 64),      # MQA
]


@pytest.mark.parametrize("layout", ["kernel", "model"])
@pytest.mark.parametrize("shape", SHAPES)
def test_map_extents_are_the_sequence_lengths(shape, layout):
    B, H, Hk, Sq, Skv, Dh = shape
    q = _kernel_layout(B, H, Sq, Dh, layout)
    k = _kernel_layout(B, Hk, Skv, Dh, layout)
    gq = fa.tma_map_geometry("q", q, fa.TMA_Q_ROWS)
    gk = fa.tma_map_geometry("k", k, fa.TMA_KV_ROWS)
    # dims innermost first; S is its own dimension, so that a ragged tile
    # reads zeros past Sq, not the next head's rows
    assert gq[:4] == (Dh, Sq, H, B)
    assert gk[:4] == (Dh, Skv, Hk, B)
    assert gq[7:] == (fa.TMA_SLAB, fa.TMA_Q_ROWS, 1, 1)
    assert gk[7:] == (fa.TMA_SLAB, fa.TMA_KV_ROWS, 1, 1)


@pytest.mark.parametrize("layout", ["kernel", "model"])
@pytest.mark.parametrize("shape", SHAPES)
def test_map_strides_are_the_byte_strides(shape, layout):
    B, H, _, Sq, _, Dh = shape
    q = _kernel_layout(B, H, Sq, Dh, layout)
    strides = fa.tma_map_geometry("q", q, fa.TMA_Q_ROWS)[4:7]
    assert strides == (q.stride(2) * 2, q.stride(1) * 2, q.stride(0) * 2)
    if layout == "model":  # rows H * Dh apart, heads Dh apart
        assert strides == (2 * H * Dh, 2 * Dh, 2 * Sq * H * Dh)
    assert all(s % 16 == 0 for s in strides)


@pytest.mark.parametrize("Dh, slabs", [(64, 1), (128, 2)])
def test_a_slab_is_64_columns(Dh, slabs):
    g = fa.tma_map_geometry("o", torch.zeros(1, 2, 100, Dh, dtype=torch.bfloat16), fa.TMA_O_ROWS)
    assert g[0] // g[7] == slabs  # boxes across Dh
    assert g[7] * 2 == 128  # bytes of one swizzled row
    assert g[8] == fa.TMA_O_ROWS


def test_maps_of_the_forward():
    q, o = (torch.zeros(2, 24, 200, 128, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.zeros(2, 8, 300, 128, dtype=torch.bfloat16) for _ in range(2))
    maps = fa._fwd_maps(q, k, v, o)
    fields = list(maps)
    assert len(fields) == 4 * 11
    rows = (fa.TMA_Q_ROWS, fa.TMA_KV_ROWS, fa.TMA_KV_ROWS, fa.TMA_O_ROWS)
    extents = (200, 300, 300, 200)
    for i, (r, s) in enumerate(zip(rows, extents)):
        g = fields[11 * i:11 * i + 11]
        assert g[1] == s and g[8] == r


@pytest.mark.parametrize("dtype, Dh", [(torch.float32, 128), (torch.float32, 64),
                                       (torch.bfloat16, 32), (torch.bfloat16, 16),
                                       (torch.float32, 320)])
def test_no_maps_where_the_forward_takes_none(dtype, Dh):
    q = torch.zeros(1, 2, 64, Dh, dtype=dtype)
    assert fa._fwd_maps(q, q, q, q) is None


def test_a_stride_of_no_whole_16_bytes_is_refused():
    # rows 72 elements (144 bytes) apart, then a view of 64 of them: rows
    # are 16-byte aligned; 68 elements (136 bytes) are not
    ok = torch.zeros(1, 2, 100, 72, dtype=torch.bfloat16)[..., :64]
    assert fa.tma_map_geometry("q", ok, fa.TMA_Q_ROWS)[4] == 144
    bad = torch.zeros(1, 2, 100, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.tma_map_geometry("q", bad, fa.TMA_Q_ROWS)


def test_a_misaligned_base_is_refused():
    flat = torch.zeros(2 * 100 * 64 + 8, dtype=torch.bfloat16)
    t = flat[1:1 + 2 * 100 * 64].view(1, 2, 100, 64)  # 2 bytes past an aligned base
    assert t.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.tma_map_geometry("k", t, fa.TMA_KV_ROWS)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa._fwd_maps(t, t, t, t)


def test_a_last_dim_that_is_not_contiguous_is_refused():
    t = torch.zeros(1, 2, 100, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.tma_map_geometry("v", t, fa.TMA_KV_ROWS)


@pytest.mark.parametrize("err, match", [(-500, "encoding a TMA tensor map failed: CUresult 500"),
                                        (1, "launch failed: CUDA error 1")])
def test_a_failed_encode_or_launch_raises(err, match):
    # the C entry point returns minus the CUresult of a failed encode, else
    # the cudaError_t of the launch
    with pytest.raises(RuntimeError, match=match):
        fa._raise_on(err, "flash_fwd")


BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


@pytest.mark.parametrize("layout", ["kernel", "model"])
@pytest.mark.parametrize("name", BWD_KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_maps_of_the_backward(shape, name, layout):
    # q, k, v and do all in one layout: the model's backward passes do as a
    # transposed view of (B, S, H, Dh) like q
    B, H, Hk, Sq, Skv, Dh = shape
    q, do = (_kernel_layout(B, H, Sq, Dh, layout) for _ in range(2))
    k, v = (_kernel_layout(B, Hk, Skv, Dh, layout) for _ in range(2))
    fields = list(fa._bwd_maps(name, q, k, v, do))
    assert len(fields) == 4 * 11
    dims = ((Dh, Sq, H, B), (Dh, Skv, Hk, B), (Dh, Skv, Hk, B), (Dh, Sq, H, B))
    for i, (t, want, rows) in enumerate(zip((q, k, v, do), dims, fa.TMA_BWD_ROWS[name, Dh])):
        g = fields[11 * i:11 * i + 11]
        assert tuple(g[:4]) == want
        assert tuple(g[4:7]) == (t.stride(2) * 2, t.stride(1) * 2, t.stride(0) * 2)
        assert tuple(g[7:]) == (fa.TMA_SLAB, rows, 1, 1)


@pytest.mark.parametrize("name, Dh, q_rows, kv_rows", [
    ("flash_bwd_dq", 64, 128, 128), ("flash_bwd_dq", 128, 128, 128),
    ("flash_bwd_dq", 320, 64, 48),
    ("flash_bwd_dkv", 64, 64, 128), ("flash_bwd_dkv", 128, 64, 128),
    ("flash_bwd_dkv", 320, 48, 64)])
def test_backward_boxes_are_the_kernels_tiles(name, Dh, q_rows, kv_rows):
    # dq walks 128-row items reading 128-key k / v tiles, at Dh 320 64-row
    # items over 48-key tiles; dk/dv walks q steps of 64 rows over items of
    # 128 keys, at Dh 320 steps of 48 over 64 keys
    assert fa.TMA_BWD_ROWS[name, Dh] == (q_rows, kv_rows, kv_rows, q_rows)


@pytest.mark.parametrize("name", BWD_KERNELS)
@pytest.mark.parametrize("dtype, Dh", [(torch.float32, 128), (torch.float32, 64),
                                       (torch.bfloat16, 32), (torch.bfloat16, 16)])
def test_no_maps_where_the_backward_takes_none(dtype, Dh, name):
    q = torch.zeros(1, 2, 64, Dh, dtype=dtype)
    assert fa._bwd_maps(name, q, q, q, q) is None


def _bad_layout(kind, shape):
    """A bf16 tensor of ``shape`` that TMA cannot take."""
    B, H, S, Dh = shape
    if kind == "misaligned base":  # 2 bytes past an aligned one
        n = B * H * S * Dh
        t = torch.zeros(n + 8, dtype=torch.bfloat16)[1:1 + n].view(shape)
        assert t.data_ptr() % 16 == 2
        return t
    if kind == "rows 136 bytes apart":
        return torch.zeros(B, H, S, Dh + 4, dtype=torch.bfloat16)[..., :Dh]
    return torch.zeros(B, H, S, 2 * Dh, dtype=torch.bfloat16)[..., ::2]  # strided last dim


@pytest.mark.parametrize("bad", ["q", "k", "v", "do"])
@pytest.mark.parametrize("kind, match", [("misaligned base", "16-byte aligned rows"),
                                         ("rows 136 bytes apart", "16-byte aligned rows"),
                                         ("strided last dim", "contiguous last dim")])
@pytest.mark.parametrize("name", BWD_KERNELS)
def test_the_backward_refuses_a_layout_tma_cannot_take(name, kind, match, bad):
    shapes = {"q": (1, 4, 100, 64), "k": (1, 2, 100, 64), "v": (1, 2, 100, 64),
              "do": (1, 4, 100, 64)}
    tensors = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    tensors[bad] = _bad_layout(kind, shapes[bad])
    with pytest.raises(ValueError, match=f"^{bad} needs .*{match}"):
        fa._bwd_maps(name, **tensors)


# head_dim 320 (gemma3-4b): the forward, dq and dk/dv are TMA / wgmma kernels
D320_SHAPES = [
    # B, H, Hk, Sq, Skv, Dh
    (4, 8, 4, 2048, 2048, 320),    # gemma3-4b prefill
    (2, 8, 4, 2048, 2048, 320),    # gemma3-4b training
    (2, 4, 2, 333, 333, 320),      # ragged: 333 is no multiple of 32, 48, 64 or 128
    (1, 8, 4, 40, 40, 320),        # Sq < one q tile or step, < one 64-key item
    (1, 8, 8, 256, 256, 320),      # MHA
]


def _d320_tensors(shape, layout):
    B, H, Hk, Sq, Skv, Dh = shape
    q, o = (_kernel_layout(B, H, Sq, Dh, layout) for _ in range(2))
    k, v = (_kernel_layout(B, Hk, Skv, Dh, layout) for _ in range(2))
    return q, k, v, o


def _check_maps(fields, tensors, dims, rows):
    assert len(fields) == 11 * len(rows)
    for i, (t, want, r) in enumerate(zip(tensors, dims, rows)):
        g = fields[11 * i:11 * i + 11]
        assert tuple(g[:4]) == want
        assert tuple(g[4:7]) == (t.stride(2) * 2, t.stride(1) * 2, t.stride(0) * 2)
        assert tuple(g[7:]) == (fa.TMA_SLAB, r, 1, 1)


@pytest.mark.parametrize("layout", ["kernel", "model"])
@pytest.mark.parametrize("shape", D320_SHAPES)
def test_forward_maps_at_head_dim_320(shape, layout):
    # q, k and v only: the Dh-320 kernel stores o from registers; 128-row q
    # tiles and 48-key k / v tiles, the bytes its barriers count
    B, H, Hk, Sq, Skv, Dh = shape
    q, k, v, o = _d320_tensors(shape, layout)
    fields = list(fa._fwd_maps(q, k, v, o))
    assert fa.TMA_FWD_ROWS[320] == (128, 48, 48)
    _check_maps(fields, (q, k, v), ((Dh, Sq, H, B), (Dh, Skv, Hk, B), (Dh, Skv, Hk, B)),
                fa.TMA_FWD_ROWS[320])


@pytest.mark.parametrize("layout", ["kernel", "model"])
@pytest.mark.parametrize("shape", D320_SHAPES)
def test_dkv_maps_at_head_dim_320(shape, layout):
    # 48-row q / do steps over items of 64 keys
    B, H, Hk, Sq, Skv, Dh = shape
    q, k, v, do = _d320_tensors(shape, layout)
    fields = list(fa._bwd_maps("flash_bwd_dkv", q, k, v, do))
    dims = ((Dh, Sq, H, B), (Dh, Skv, Hk, B), (Dh, Skv, Hk, B), (Dh, Sq, H, B))
    _check_maps(fields, (q, k, v, do), dims, (48, 64, 64, 48))


@pytest.mark.parametrize("layout", ["kernel", "model"])
@pytest.mark.parametrize("shape", D320_SHAPES)
def test_dq_maps_at_head_dim_320(shape, layout):
    # 64-row q / do tiles (an item) over 48-key k / v tiles (a step of one
    # consumer), the bytes the kernel's barriers count
    B, H, Hk, Sq, Skv, Dh = shape
    q, k, v, do = _d320_tensors(shape, layout)
    fields = list(fa._bwd_maps("flash_bwd_dq", q, k, v, do))
    dims = ((Dh, Sq, H, B), (Dh, Skv, Hk, B), (Dh, Skv, Hk, B), (Dh, Sq, H, B))
    assert fa.TMA_BWD_ROWS["flash_bwd_dq", 320] == (64, 48, 48, 64)
    _check_maps(fields, (q, k, v, do), dims, (64, 48, 48, 64))


def test_the_forward_map_boxes_by_head_dim():
    # Dh 64 / 128: q, k, v and o; Dh 320: no o map
    for Dh in (64, 128):
        assert fa.TMA_FWD_ROWS[Dh] == (fa.TMA_Q_ROWS, fa.TMA_KV_ROWS, fa.TMA_KV_ROWS,
                                       fa.TMA_O_ROWS)
    assert len(fa.TMA_FWD_ROWS[320]) == 3
    assert set(fa.TMA_FWD_ROWS) == {64, 128, 320}


# The f32 forward's key split (flash_fwd.cu: flash_fwd_tf32_kernel, then
# flash_fwd_combine_kernel): (B, H, Sq, Skv) and the (splits, keys a split)
# that an H100's 132 SMs give.
F32_SPLITS = [
    ((1, 4, 333, 333), (6, 64)),      # d320_ragged_f32: 24 blocks of 64 rows
    ((1, 8, 2048, 2048), (1, 2048)),  # gemma3_global_f32: 256 blocks fill the card
    ((4, 2, 128, 128), (2, 64)),      # gemma3-smoke at Dh 320 (the model phase)
    ((2, 8, 1000, 1000), (1, 1024)),  # the f32 case at Dh 128
    ((1, 4, 1, 333), (6, 64)),        # Sq 1: as many splits as 64-key chunks
    ((1, 4, 17, 128), (2, 64)),
    ((1, 4, 200, 300), (5, 64)),
]


@pytest.mark.parametrize("shape, want", F32_SPLITS)
def test_f32_key_split_at_the_cards_shapes(shape, want):
    assert fa.f32_key_split(*shape, sms=132) == want


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
@pytest.mark.parametrize("shape", [s for s, _ in F32_SPLITS])
def test_f32_key_split_covers_the_keys(shape, sms):
    B, H, Sq, Skv = shape
    splits, chunk = fa.f32_key_split(B, H, Sq, Skv, sms)
    assert chunk % fa.F32_CHUNK == 0  # a split starts on a step
    assert (splits - 1) * chunk < Skv <= splits * chunk  # every key, no split past them
    assert splits == 1 or chunk >= fa.F32_MIN_SPLIT
    blocks = -(-Sq // fa.F32_ROWS) * H * B
    assert (splits - 1) * blocks < sms  # no more splits than it takes to fill the card


def test_f32_split_scratch():
    assert fa.f32_split_scratch(1, 1, 8, 2048, 320) == 0
    # each split's o and its rows' (max, sum)
    assert fa.f32_split_scratch(6, 1, 4, 333, 320) == 6 * 4 * 333 * (320 + 2)


def _key_range(Sq, Skv, causal, window, q_offset, r0, r1):
    """flash_common.cuh's key_range: the keys rows [r0, r1) can see."""
    qmin, qmax = r0 + q_offset, r1 - 1 + q_offset
    if window is not None and qmax - window + 1 >= Skv:
        return 0, Skv  # the last row sees no key: every key
    lo = max(0, qmin - window + 1) if window is not None else 0
    return lo, (min(Skv, qmax + 1) if causal else Skv)


def _split_forward(q, k, v, *, causal, window, q_offset, splits, chunk):
    """The f32 forward's arithmetic in torch: each 64-row block's key splits
    (whole 32-key steps from the block's first key, cut at multiples of
    ``chunk``), each split's (m, l, O) over the scores of its steps in the
    log2 domain (masked -1e30, -inf past Skv), then the combine over the
    splits that hold keys; -> (o, lse)."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    ke, ve = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
    x = torch.einsum("bhqd,bhkd->bhqk", q, ke) * (Dh ** -0.5 * math.log2(math.e))
    x = torch.where(attention_mask(Sq, Skv, causal, window, q_offset), x, NEG_INF)
    o, lse = torch.empty_like(q), torch.empty(B, H, Sq)
    for r0 in range(0, Sq, fa.F32_ROWS):
        r1 = min(Sq, r0 + fa.F32_ROWS)
        k_lo, k_hi = _key_range(Sq, Skv, causal, window, q_offset, r0, r1)
        parts = []
        for s in range(splits):
            step = fa.F32_CHUNK  # the kernel's keys a step
            lo, hi = max(k_lo // step * step, s * chunk), min(k_hi, (s + 1) * chunk)
            if lo >= hi:
                continue
            end = min(Skv, lo + -(-(hi - lo) // step) * step)
            xs = x[:, :, r0:r1, lo:end]
            m = xs.amax(-1, keepdim=True)
            p = torch.exp2(xs - m)
            parts.append((m, p.sum(-1, keepdim=True), p @ ve[:, :, lo:end]))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(m - M) for m, _, _ in parts]
        L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
        o[:, :, r0:r1] = sum(wi * oi for wi, (_, _, oi) in zip(w, parts)) / L
        lse[:, :, r0:r1] = (torch.where(M == NEG_INF, 0.0, M * math.log(2)) + torch.log(L))[..., 0]
    return o, lse


@pytest.mark.parametrize("case", [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset
    (1, 4, 2, 333, 333, 16, True, None, 0),     # d320_ragged_f32's geometry, 6 splits
    (1, 4, 2, 200, 300, 16, False, 64, 50),     # a window, Sq != Skv
    (1, 4, 2, 64, 128, 16, False, 16, 100),     # rows that see no key average v
    (2, 2, 1, 128, 128, 32, True, 8, 0),        # gemma3-smoke's window of 8
    (1, 4, 2, 17, 128, 16, True, None, 111),    # Sq 17 at the end of the keys
    (1, 4, 2, 1, 333, 16, True, None, 332),     # Sq 1: one row over every split
])
def test_f32_split_and_combine_give_the_plain_forward(case):
    from repro_torch.kernels.flash_attention.ref import attention_fwd_lse_ref

    B, H, Hk, Sq, Skv, Dh, causal, window, q_offset = case
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, h, S, Dh, generator=g)
               for h, S in ((H, Sq), (Hk, Skv), (Hk, Skv)))
    splits, chunk = fa.f32_key_split(B, H, Sq, Skv, sms=132)
    assert splits > 1  # each case splits the keys
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = _split_forward(q, k, v, splits=splits, chunk=chunk, **kw)
    o_ref, lse_ref = attention_fwd_lse_ref(q, k, v, **kw)
    assert (o - o_ref).abs().max().item() <= 1e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-5
