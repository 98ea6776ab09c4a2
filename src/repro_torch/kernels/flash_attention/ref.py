"""Plain PyTorch versions of the flash attention kernels (counterpart of
``repro/kernels/flash_attention/ref.py``).

Semantics: causal (optionally sliding-window) GQA attention,
q (B, H, Sq, Dh), k/v (B, Hk, Skv, Dh), f32 scores and softmax, output in
q.dtype.  Query head h reads kv head h // (H // Hk).  ``q_offset`` places the
q block at absolute position q_offset in the kv timeline.  Masked scores are
-1e30, never -inf, so a row that sees no key averages v over all keys.

``attention_fwd_lse_ref`` also returns the f32 logsumexp of each row's
masked, scaled scores, and ``attention_bwd_ref`` is the gradient of
``attention_ref`` rebuilt from that lse, written out (P, dP, dS).  A row that
sees no key has lse = log(Skv): the logsumexp of its uniform scores taken as
0, so that the backward rebuilds P = 1/Skv (the TPU kernel stores
-1e30 + log(Skv), which rounds to -1e30, and its backward then takes P = 1).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _grouped_scores(q, k, causal, window, scale, q_offset):
    """f32 scaled scores (B, Hk, group, Sq, Skv) and the visibility mask."""
    B, H, Sq, Dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    qg = (q.to(torch.float32) * scale).reshape(B, Hk, H // Hk, Sq, Dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    return s, attention_mask(Sq, Skv, causal, window, q_offset, q.device)


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
    if scale is None:
        scale = Dh ** -0.5
    logits, mask = _grouped_scores(q, k, causal, window, scale, q_offset)
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(torch.float32))
    return out.reshape(B, H, Sq, Dh).to(q.dtype)


def attention_fwd_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (o like q, lse (B, H, Sq) f32)."""
    B, H, Sq, Dh = q.shape
    Skv = k.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    o = attention_ref(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)
    s, mask = _grouped_scores(q, k, causal, window, scale, q_offset)
    lse = torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)
    lse = torch.where(mask.any(dim=-1), lse, math.log(Skv))
    return o, lse.reshape(B, H, Sq)


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dq, dk, dv) in the dtypes of q, k, v; f32 throughout.  dk/dv are
    summed over each kv head's query group."""
    B, H, Sq, Dh = q.shape
    Hk = k.shape[1]
    group = H // Hk
    if scale is None:
        scale = Dh ** -0.5
    f32 = torch.float32
    s, mask = _grouped_scores(q, k, causal, window, scale, q_offset)
    lse_g = lse.to(f32).reshape(B, Hk, group, Sq, 1)
    no_key = ~mask.any(dim=-1, keepdim=True)
    # P on visible pairs; 1/Skv (exp(-lse)) on every key of a row that sees none
    p = torch.where(mask, torch.exp(s - lse_g), torch.where(no_key, torch.exp(-lse_g), 0.0))
    do_g = do.to(f32).reshape(B, Hk, group, Sq, Dh)
    delta = (o.to(f32).reshape(B, Hk, group, Sq, Dh) * do_g).sum(-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do_g, v.to(f32))
    ds = torch.where(mask, p * (dp - delta), 0.0)   # the mask stops the gradient
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(f32)) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, q.to(f32).reshape(B, Hk, group, Sq, Dh)) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do_g)
    return dq.reshape(B, H, Sq, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
