"""Plain PyTorch versions of the chunkwise mLSTM (counterpart of
``repro/kernels/mlstm/ref.py`` and of ``repro/models/ssm._mlstm_chunked``).

* ``mlstm_ref``: the sequential stabilised recurrence (xLSTM's matrix memory
  C, normaliser n, stabiliser m), one step per position: the oracle, and the
  function whose gradient ``ops.mlstm`` takes;
* ``mlstm_chunked_ref``: the chunkwise form the kernel computes; the wrapper
  runs it on CPU tensors.  It pads S up to a multiple of the chunk with
  zeros and an input gate of -1e30, as the reference does.

Both divide by max(|q.n|, exp(-m)).  ``mlstm_step`` is one step of the
recurrence, shared by ``mlstm_ref`` and the model's decode, which divides by
max(|q.n|, 1) instead (a reference quirk, kept in ``models/ssm.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


def mlstm_step(
    C: torch.Tensor, n: torch.Tensor, m: torch.Tensor,      # (B,H,D,D), (B,H,D), (B,H)
    qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,   # (B, H, D)
    it: torch.Tensor, lf: torch.Tensor,                     # (B, H)
    floor: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One position of the stabilised recurrence: returns (h, C, n, m), h
    divided by max(|q.n|, exp(-m)), or by max(|q.n|, floor) given a floor."""
    m_new = torch.maximum(lf + m, it)
    fdec = torch.exp(lf + m - m_new)
    iamp = torch.exp(it - m_new)
    C = C * fdec[..., None, None] + iamp[..., None, None] * (kt[..., :, None] * vt[..., None, :])
    n = n * fdec[..., None] + iamp[..., None] * kt
    qn = torch.abs(torch.einsum("bhd,bhd->bh", qt, n))
    denom = torch.maximum(qn, torch.exp(-m_new)) if floor is None else torch.clamp(qn, min=floor)
    return torch.einsum("bhd,bhde->bhe", qt, C) / denom[..., None], C, n, m_new


def mlstm_ref(
    q: torch.Tensor,       # (B, S, H, D) pre-scaled
    k: torch.Tensor,       # (B, S, H, D)
    v: torch.Tensor,       # (B, S, H, D)
    i_gate: torch.Tensor,  # (B, S, H)
    logf: torch.Tensor,    # (B, S, H) log-sigmoid forget
) -> torch.Tensor:
    B, S, H, D = q.shape
    C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG, dtype=torch.float32, device=q.device)
    ys = []
    for t in range(S):
        h, C, n, m = mlstm_step(C, n, m, q[:, t], k[:, t], v[:, t], i_gate[:, t], logf[:, t])
        ys.append(h)
    return torch.stack(ys, dim=1)


def mlstm_chunked_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    i_gate: torch.Tensor, logf: torch.Tensor, chunk: int,
) -> torch.Tensor:
    """Chunkwise-parallel stabilised mLSTM (all f32).

    q, k, v (B, S, H, D); i_gate, logf (B, S, H).  O(S * chunk) memory.
    """
    B, S, H, Dh = q.shape
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=NEG)
    nc = (S + pad) // chunk

    def to_chunks(a):
        return a.reshape(B, nc, chunk, *a.shape[2:]).movedim(1, 0)  # (nc, B, c, ...)

    qc, kc, vc, ic, fc = map(to_chunks, (q, k, v, i_gate, logf))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    C = torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG, dtype=torch.float32, device=q.device)
    hs = []
    for qz, kz, vz, iz, fz in zip(qc, kc, vc, ic, fc):
        cumf = torch.cumsum(fz, dim=1)                                # (B, c, H) inclusive
        # intra exponents b_ts = cumf_t - cumf_s + i_s  (s <= t)
        b = cumf[:, :, None, :] - cumf[:, None, :, :] + iz[:, None, :, :]
        b = torch.where(causal[None, :, :, None], b, -torch.inf)
        # inter exponent c_t = cumf_t + m_in
        c_t = cumf + m[:, None, :]                                    # (B, c, H)
        m_t = torch.maximum(torch.amax(b, dim=2), c_t)                # (B, c, H)
        m_t = torch.clamp(m_t, min=NEG)
        w = torch.exp(b - m_t[:, :, None, :])                         # (B, t, s, H)
        qk = torch.einsum("bthd,bshd->btsh", qz, kz)
        y = torch.einsum("btsh,bshd->bthd", w * qk, vz)
        inter_amp = torch.exp(c_t - m_t)                              # (B, t, H)
        y = y + inter_amp[..., None] * torch.einsum("bthd,bhde->bthe", qz, C)
        n_t = torch.einsum("btsh,bshd->bthd", w, kz) + inter_amp[..., None] * n[:, None]
        qn = torch.einsum("bthd,bthd->bth", qz, n_t)
        hs.append(y / torch.maximum(torch.abs(qn), torch.exp(-m_t))[..., None])
        # state update to the end of the chunk
        fe = cumf[:, -1]                                              # (B, H)
        e_s = fe[:, None, :] - cumf + iz                              # (B, s, H)
        m_out = torch.maximum(m + fe, torch.amax(e_s, dim=1))
        amp_s = torch.exp(e_s - m_out[:, None, :])                    # (B, s, H)
        decay = torch.exp(m + fe - m_out)
        C = C * decay[..., None, None] + torch.einsum("bsh,bshd,bshe->bhde", amp_s, kz, vz)
        n = n * decay[..., None] + torch.einsum("bsh,bshd->bhd", amp_s, kz)
        m = m_out
    out = torch.stack(hs, dim=1).reshape(B, nc * chunk, H, Dh)
    return out[:, :S]
