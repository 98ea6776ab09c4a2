"""Least times on an H100 for the SSD and mLSTM kernels, reckoned from their
shapes (nothing runs; no card needed):

    PYTHONPATH=src python -m repro_torch.kernels.bounds

The model path runs both kernels in f32 (the reference casts their inputs
to f32), so the work must keep f32 accuracy.  The fastest f32-accurate route
on the card is 3xTF32 on the tensor cores (three TF32 products per f32
product: 495 / 3 = 165 TFLOP/s), faster than f32 outside them (67 TFLOP/s).
Each bound is the larger of the operations over that rate and the bytes
(each input read once, each output written once, in f32; the kernels'
scratch is not counted) over the HBM rate (3.35 TB/s), NVIDIA's H100 SXM
data-sheet numbers.  The bound over the f32 SIMT peak, which the kernels'
first port (f32 FMA) was held to, is kept beside it as ``simt_bound_ms``.  The shapes are those the reference's models give the kernels at
batch 4 x 1024 tokens:

* ``ssd_fwd`` (src/repro/kernels/ssd/ssd.py:68) at zamba2-7b: Mamba2 with
  d_inner = 2 x 3584, head dim P = 64 (112 heads), state N = 64, chunk 64.
  C B^T (2 x 64^3 FLOP) once per (batch, chunk), since B and C are shared
  by every head; per (batch, head, chunk) three more products of 2 x 64^3:
  the decay-masked C B^T with x dt, C state^T and the state update.
* ``mlstm_fwd`` (src/repro/kernels/mlstm/mlstm.py:75) at xlstm-125m:
  4 heads of D = 768 / 4 = 192, chunk C = 64.  Per (batch, head, chunk):
  q k^T and (w o qk) v (2 C^2 D each), q C_state and the state update
  (2 C D^2 each).  The normaliser q.n_t needs no third C^2 D product: it is
  the row sum of w o qk plus a multiple of q.n.

``chip_smoke.py`` reckons the same bounds from the tensors it times.
"""

from __future__ import annotations

from typing import Dict

PEAK_SIMT = 67e12    # f32, outside the tensor cores
PEAK_TF32 = 495e12   # TF32 tensor cores, dense
TF32_PASSES = 3      # hi hi + hi lo + lo hi: f32-accurate
PEAK_FLOPS = max(PEAK_SIMT, PEAK_TF32 / TF32_PASSES)  # the f32-accurate rate: 165e12
PEAK_BYTES = 3.35e12  # HBM3
F32 = 4


def _bound(flops: float, nbytes: float) -> Dict[str, float]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    out = {"flops": flops, "bytes": nbytes}
    for key, peak in (("", PEAK_FLOPS), ("simt_", PEAK_SIMT)):
        t_ops = flops / peak * 1e3
        out[f"{key}bound_ms"] = max(t_ops, t_bytes)
        out[f"{key}bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> float:
    """C B^T (2 c^2 N) per (batch, chunk); its product with x dt (2 c^2 P),
    C state^T and the state update (2 c P N each) per (batch, head, chunk)."""
    c = chunk
    return (2.0 * c * c * N + (2.0 * c * c * P + 4.0 * c * P * N) * H) * B * (S // c)


def mlstm_flops(B: int, S: int, H: int, D: int, chunk: int) -> float:
    return (2 * 2.0 * chunk ** 2 * D + 2 * 2.0 * chunk * D ** 2) * B * H * (S // chunk)


def ssd_bound(B=4, S=1024, d_model=3584, expand=2, P=64, N=64, chunk=64) -> Dict[str, float]:
    H = expand * d_model // P
    # x and y (B, S, H, P); dt (B, S, H); B and C (B, S, N); A (H,)
    nbytes = F32 * (2 * B * S * H * P + B * S * H + 2 * B * S * N + H)
    return _bound(ssd_flops(B, S, H, P, N, chunk), nbytes)


def mlstm_bound(B=4, S=1024, d_model=768, heads=4, chunk=64) -> Dict[str, float]:
    D = d_model // heads
    # q, k, v and y (B, S, H, D); the input and forget gates (B, S, H)
    nbytes = F32 * (4 * B * S * heads * D + 2 * B * S * heads)
    return _bound(mlstm_flops(B, S, heads, D, chunk), nbytes)


def main() -> None:
    for name, b in (("ssd_fwd at zamba2-7b", ssd_bound()), ("mlstm_fwd at xlstm-125m", mlstm_bound())):
        print(f"{name}, batch 4 x 1024 tokens, f32: {b['flops']:.4g} FLOP, {b['bytes']:.4g} B, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; f32 SIMT "
              f"{b['simt_bound_ms']:.4f} ms, {b['simt_bound_by']})")


if __name__ == "__main__":
    main()
