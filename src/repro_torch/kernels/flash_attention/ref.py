"""Plain PyTorch version of the flash attention forward (counterpart of
``repro/kernels/flash_attention/ref.py``).

Semantics: causal (optionally sliding-window) GQA attention,
q (B, H, Sq, Dh), k/v (B, Hk, Skv, Dh), f32 scores and softmax, output in
q.dtype.  Query head h reads kv head h // (H // Hk).  ``q_offset`` places the
q block at absolute position q_offset in the kv timeline.  Masked scores are
-1e30, never -inf, so a row that sees no key averages v over all keys.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(
    q_len: int, kv_len: int, causal: bool, window: Optional[int],
    q_offset: int = 0, device=None,
) -> torch.Tensor:
    """(q_len, kv_len) boolean mask of the keys each query row sees."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    group = H // Hk
    if scale is None:
        scale = Dh ** -0.5
    qf = q.to(torch.float32) * scale
    qg = qf.reshape(B, Hk, group, Sq, Dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    mask = attention_mask(Sq, Skv, causal, window, q_offset, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(torch.float32))
    return out.reshape(B, H, Sq, Dh).to(q.dtype)
