"""Why the scan kernels take their products in 3xTF32 (CPU only).

TF32 keeps 10 of f32's 23 mantissa bits.  The chunked plain versions of the
SSD scan and of the mLSTM are run with every product the CUDA kernels put on
the tensor cores emulated: each operand split into a TF32 high part and a
TF32 residual, and the product taken in one pass (hi hi) or three (hi hi +
hi lo + lo hi).  Two ways to split: rounded to nearest (cvt.rna.tf32.f32 on
both parts) and truncated (the high part's low 13 bits cleared, the residual
read by the tensor cores' top 19 bits: what the kernels do).  Elementwise
factors are folded into an operand in f32 first, as the kernels fold them;
weighted sums and dot products the kernels take in f32 stay f32.

Against the f32 chunked version, relative to max |y|, at the shapes below:
one pass reads 6.1e-4 (SSD) and 1.2e-3 (mLSTM) with rounding, 1.7e-3 and
1.4e-3 with truncation, past the 1e-4 the card tests hold the kernels to;
three passes read 3.1e-7 and 8.6e-7 with rounding, 9.4e-7 and 1.4e-6 with
truncation.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.mlstm.ref import mlstm_chunkstate_ref  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_ref  # noqa: E402

_einsum = torch.einsum
# the card tests' bound on a scan kernel against its chunked plain version
KERNEL_REL = 1e-4


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from zero,
    as cvt.rna.tf32.f32), kept in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by clearing the low 13 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x, mode):
    to = round_tf32 if mode == "rna" else truncate_tf32
    hi = to(x)
    return hi, to(x - hi)


def tf32_einsum(passes: int, mode: str):
    """torch.einsum with its matrix products emulated in ``passes`` TF32
    passes; elementwise factors folded in first, in f32."""

    def product(eq, a, b):
        ins, out = eq.split("->")
        sa, sb = ins.split(",")
        if set(sa) <= set(sb) or set(sb) <= set(sa):  # a weighted sum: f32 in the kernels
            return _einsum(eq, a, b)
        (ahi, alo), (bhi, blo) = _split(a, mode), _split(b, mode)
        terms = [(ahi, bhi)] + ([(ahi, blo), (alo, bhi)] if passes == 3 else [])
        return sum(_einsum(eq, x.double(), y.double()) for x, y in terms).float()

    def einsum(eq, *ops):
        ins, out = eq.replace(" ", "").split("->")
        subs = ins.split(",")
        if len(ops) == 2:
            return product(eq, *ops)
        assert len(ops) == 3, eq
        for i, si in enumerate(subs):  # a factor on one operand's indices: fold it in
            for j, sj in enumerate(subs):
                if i != j and set(si) <= set(sj):
                    folded = _einsum(f"{sj},{si}->{sj}", ops[j], ops[i])
                    (k,) = set(range(3)) - {i, j}
                    pair = sorted([(j, sj, folded), (k, subs[k], ops[k])])
                    return product(f"{pair[0][1]},{pair[1][1]}->{out}", pair[0][2], pair[1][2])
        i = next(i for i, si in enumerate(subs) if set(si) <= set(out))  # a factor on the output
        rest = [(subs[k], ops[k]) for k in range(3) if k != i]
        mid = product(f"{rest[0][0]},{rest[1][0]}->{out}", rest[0][1], rest[1][1])
        return _einsum(f"{out},{subs[i]}->{out}", mid, ops[i])

    return einsum


def _ssd_inputs(seed=0):
    # zamba2-like: P = N = 64, chunk 64, 4 heads
    rng = np.random.RandomState(seed)
    B, S, H, P, N = 2, 512, 4, 64, 64
    return [torch.from_numpy(a) for a in (
        rng.randn(B, S, H, P).astype(np.float32),
        (np.abs(rng.randn(B, S, H)) * 0.1 + 0.01).astype(np.float32),
        rng.randn(B, S, N).astype(np.float32), rng.randn(B, S, N).astype(np.float32),
        (-(np.abs(rng.randn(H)) + 0.5)).astype(np.float32))]


def _mlstm_inputs(seed=0):
    # xlstm-like: D = 192, chunk 64
    rng = np.random.RandomState(seed)
    B, S, H, D = 1, 256, 2, 192
    q = (rng.randn(B, S, H, D) / np.sqrt(D)).astype(np.float32)
    k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(2))
    ig = rng.randn(B, S, H).astype(np.float32)
    lf = -np.log1p(np.exp(-(rng.randn(B, S, H) + 2))).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v, ig, lf)]


def _run(which):
    if which == "ssd":
        return ssd_chunked_ref(*_ssd_inputs(), 64)[0]
    return mlstm_chunkstate_ref(*_mlstm_inputs(), 64)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -1.0 - 2 ** -11,
                      3.14159265])
    got = round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -1.0 - 2 ** -10,
                         3.140625])
    assert torch.equal(got, want)
    assert torch.equal(truncate_tf32(x[2:4]), torch.ones(2))
    # the residual of the split is exact in f32, and itself TF32 after rounding
    hi, lo = _split(x, "rna")
    assert torch.equal(round_tf32(lo), lo)
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -21).all()


@pytest.mark.parametrize("mode", ["rna", "truncate"])
@pytest.mark.parametrize("which", ["ssd", "mlstm"])
def test_three_tf32_passes_keep_the_kernels_tolerance(monkeypatch, which, mode):
    want = _run(which)
    monkeypatch.setattr(torch, "einsum", tf32_einsum(3, mode))
    got = _run(which)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= KERNEL_REL


@pytest.mark.parametrize("mode", ["rna", "truncate"])
@pytest.mark.parametrize("which", ["ssd", "mlstm"])
def test_one_tf32_pass_does_not(monkeypatch, which, mode):
    want = _run(which)
    monkeypatch.setattr(torch, "einsum", tf32_einsum(1, mode))
    assert _rel(_run(which), want) > KERNEL_REL
