"""Operations and bytes, counted from shapes, and the card's peaks.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s in bf16 on the
tensor cores, 3.35 TB/s of HBM3.

``flash_bound_s`` is a frozen copy of the count ``chip_smoke.py`` uses for
the flash kernels' bounds (``_time_bwd_case``): over the visible (query,
key) pairs, 4 Dh FLOP a pair for the forward (QK^T and PV), 6 Dh for dq and
8 Dh for dk/dv (the products each kernel runs, the recomputed QK^T among
them); each input read once and each output written once, K and V only at
the keys some query sees.  The bound is the larger of operations at the
peak rate and bytes at the peak bandwidth.

``train_step_flops`` is a step's model operations for ``mfu``: 6 x the
matmul-active parameters x tokens (a token meets the attention projections,
the router, its top-k experts and the shared experts, or the dense MLP, in
every layer, and the unembedding; not the embedding lookup, which
multiplies nothing), plus
causal attention's forward and backward, 6 L H Dh S^2 a sequence (QK^T and
PV, 2 S^2 H Dh a layer forward over the causal half, x 3 with the
backward).  Remat's second forward and the capacity's empty expert slots are
not model operations and are not counted.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_BYTES = 3.35e12
_ELEM = {"bfloat16": 2, "float32": 4}


def visible_pairs(Sq: int, Skv: int, causal: bool, window, q_offset: int) -> Tuple[int, int]:
    """(query-key pairs a head sees, keys some query sees) of one head."""
    pairs, keys_seen = 0, 0
    last = -1
    for i in range(Sq):
        qpos = q_offset + i
        hi = min(qpos, Skv - 1) if causal else Skv - 1
        lo = max(0, qpos - window + 1) if window is not None else 0
        if hi >= lo:
            pairs += hi - lo + 1
            keys_seen += max(0, hi - max(lo, last + 1) + 1)
            last = max(last, hi)
    return pairs, keys_seen


def _causal_pairs(Sq: int, Skv: int, causal: bool, window, q_offset: int) -> Tuple[int, int]:
    """``visible_pairs`` in closed form for the plain causal square (the
    training cells' shape), else by the loop."""
    if causal and window is None and q_offset == 0 and Sq == Skv:
        return Sq * (Sq + 1) // 2, Skv
    return visible_pairs(Sq, Skv, causal, window, q_offset)


def flash_bound_s(kernel: str, B: int, H: int, Hk: int, Sq: int, Skv: int, Dh: int,
                  dtype: str, causal: bool = True, window=None, q_offset: int = 0) -> float:
    """Least seconds of ``flash_fwd_lse``, ``flash_bwd_dq`` or
    ``flash_bwd_dkv`` at one call's shape."""
    pairs, keys_seen = _causal_pairs(Sq, Skv, causal, window, q_offset)
    visible = pairs * B * H
    e = _ELEM[dtype]
    q = B * H * Sq * Dh * e
    kv_read = 2 * B * Hk * Skv * Dh * e * keys_seen / Skv
    kv = 2 * B * Hk * Skv * Dh * e
    rows = B * H * Sq * 4  # lse or delta, f32
    flops = {"flash_fwd_lse": 4.0 * Dh * visible, "flash_bwd_dq": 6.0 * Dh * visible,
             "flash_bwd_dkv": 8.0 * Dh * visible}[kernel]
    nbytes = {"flash_fwd_lse": kv_read + q + q + rows,
              "flash_bwd_dq": kv_read + q + q + rows + rows + q,
              "flash_bwd_dkv": kv_read + q + q + rows + rows + kv}[kernel]
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def matmul_active_params(model: Dict[str, Any]) -> int:
    """Parameters a token multiplies by, from the reference's sizes
    (``reference.decoder_lm.sizes``)."""
    D, H, Hk, Dh = model["d_model"], model["heads"], model["kv_heads"], model["head_dim"]
    attn = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D
    moe = model.get("moe")
    if moe:
        experts = moe["top_k"] + moe["num_shared_experts"]
        ffn = D * moe["num_experts"] + experts * 3 * D * moe["d_ff"]
    else:
        ffn = 3 * D * model["d_ff"]
    return model["num_layers"] * (attn + ffn) + D * model["vocab"]


def train_step_flops(model: Dict[str, Any], sequences: int, seq_len: int) -> float:
    """Model operations of one optimizer step over ``sequences`` rows of
    ``seq_len`` tokens."""
    dense = 6.0 * matmul_active_params(model) * sequences * seq_len
    attention = (6.0 * model["num_layers"] * model["heads"] * model["head_dim"]
                 * seq_len * seq_len * sequences)
    return dense + attention
