"""Least times on an H100 for the TPU kernels still to be ported, reckoned
from their shapes (nothing runs; no card needed):

    PYTHONPATH=src python -m repro_torch.kernels.bounds

Each bound is the larger of the operations over the bf16 tensor-core peak
(989 TFLOP/s) and the bytes (each input read once, each output written
once, in bf16) over the HBM rate (3.35 TB/s), NVIDIA's H100 SXM data-sheet
numbers.  The shapes are those the reference's models give the kernels at
batch 4 x 1024 tokens:

* ``ssd_fwd`` (src/repro/kernels/ssd/ssd.py:68) at zamba2-7b: Mamba2 with
  d_inner = 2 x 3584, head dim P = 64 (112 heads), state N = 64, chunk 64.
  Per (batch, head, chunk) four products of 2 x 64^3 FLOP: C B^T, its
  decay-masked product with x dt, C state^T and the state update.
* ``mlstm_fwd`` (src/repro/kernels/mlstm/mlstm.py:75) at xlstm-125m:
  4 heads of D = 768 / 4 = 192, chunk C = 64.  Per (batch, head, chunk):
  q k^T, (w o qk) v and w k (2 C^2 D each), q C_state and the state update
  (2 C D^2 each).
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12   # bf16 dense
PEAK_BYTES = 3.35e12  # HBM3
BF16 = 2


def _bound(flops: float, nbytes: float) -> Dict[str, float]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def ssd_bound(B=4, S=1024, d_model=3584, expand=2, P=64, N=64, chunk=64) -> Dict[str, float]:
    H = expand * d_model // P
    flops = 4 * 2.0 * chunk ** 3 * B * H * (S // chunk)
    # x and y (B, S, H, P); dt (B, S, H); B and C (B, S, N); A (H,)
    nbytes = BF16 * (2 * B * S * H * P + B * S * H + 2 * B * S * N + H)
    return _bound(flops, nbytes)


def mlstm_bound(B=4, S=1024, d_model=768, heads=4, chunk=64) -> Dict[str, float]:
    D = d_model // heads
    per_chunk = 3 * 2.0 * chunk ** 2 * D + 2 * 2.0 * chunk * D ** 2
    flops = per_chunk * B * heads * (S // chunk)
    # q, k, v and y (B, S, H, D); the input and forget gates (B, S, H)
    nbytes = BF16 * (4 * B * S * heads * D + 2 * B * S * heads)
    return _bound(flops, nbytes)


def main() -> None:
    for name, b in (("ssd_fwd at zamba2-7b", ssd_bound()), ("mlstm_fwd at xlstm-125m", mlstm_bound())):
        print(f"{name}, batch 4 x 1024 tokens, bf16: {b['flops']:.4g} FLOP, {b['bytes']:.4g} B, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")


if __name__ == "__main__":
    main()
