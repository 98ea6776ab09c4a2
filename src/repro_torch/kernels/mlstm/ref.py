"""Plain PyTorch versions of the chunkwise mLSTM (counterpart of
``repro/kernels/mlstm/ref.py`` and of ``repro/models/ssm._mlstm_chunked``).

* ``mlstm_ref``: the sequential stabilised recurrence (xLSTM's matrix memory
  C, normaliser n, stabiliser m), one step per position: the oracle, and the
  function whose gradient ``ops.mlstm`` takes;
* ``mlstm_chunked_ref``: the chunkwise form the kernel computes; the wrapper
  runs it on CPU tensors.  It pads S up to a multiple of the chunk with
  zeros and an input gate of -1e30, as the reference does;
* ``mlstm_chunkstate_ref``: the same function in the order the CUDA kernels
  sum it (the chunk states in parallel, a serial combine, the outputs).

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


def mlstm_chunkstate_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    i_gate: torch.Tensor, logf: torch.Tensor, chunk: int,
) -> torch.Tensor:
    """The chunkwise mLSTM in the order the CUDA kernels sum it (all f32).

    The chunk states in parallel, then a serial combine, then the outputs:

    1. per chunk, its own contribution: F = cumf_end, mu = max_s e_s with
       e_s = F - cumf_s + i_s, dC = sum_s exp(e_s - mu) k_s v_s^T and
       dn = sum_s exp(e_s - mu) k_s;
    2. per (batch, head), the serial combine into each chunk's incoming
       state: m_out = max(m_in + F, mu), C' = C exp(m_in + F - m_out) +
       dC exp(mu - m_out) (n alike), from C = 0, n = 0, m = -1e30;
    3. per chunk, the outputs from its incoming state, with q.n_t as the row
       sum of w o q k^T plus a_t (q.n).

    The same function as ``mlstm_chunked_ref`` (exp(e_s - mu) exp(mu - m_out)
    = exp(e_s - m_out)), the -1e30 padding included.
    """
    B, S, H, Dh = q.shape
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=NEG)
    nc = (S + pad) // chunk

    def to_chunks(a):
        return a.reshape(B, nc, chunk, *a.shape[2:])               # (B, nc, c, ...)

    qc, kc, vc, ic, fc = map(to_chunks, (q, k, v, i_gate, logf))
    cumf = torch.cumsum(fc, dim=2)                                  # (B, nc, c, H)
    # 1. each chunk's own contribution
    Fe = cumf[:, :, -1]                                             # (B, nc, H)
    e = Fe[:, :, None] - cumf + ic                                  # (B, nc, s, H)
    mu = torch.amax(e, dim=2)                                       # (B, nc, H)
    amp = torch.exp(e - mu[:, :, None])
    dC = torch.einsum("bzsh,bzshd,bzshe->bzhde", amp, kc, vc)
    dn = torch.einsum("bzsh,bzshd->bzhd", amp, kc)
    # 2. the serial combine
    C = torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG, dtype=torch.float32, device=q.device)
    C_in, n_in, m_in = [], [], []
    for z in range(nc):
        C_in.append(C), n_in.append(n), m_in.append(m)
        m_out = torch.maximum(m + Fe[:, z], mu[:, z])
        keep, add = torch.exp(m + Fe[:, z] - m_out), torch.exp(mu[:, z] - m_out)
        C = C * keep[..., None, None] + dC[:, z] * add[..., None, None]
        n = n * keep[..., None] + dn[:, z] * add[..., None]
        m = m_out
    C_in, n_in, m_in = (torch.stack(a, dim=1) for a in (C_in, n_in, m_in))
    # 3. the outputs, every chunk at once
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    b = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + ic[:, :, None, :, :]
    b = torch.where(causal[None, None, :, :, None], b, -torch.inf)  # (B, nc, t, s, H)
    c_t = cumf + m_in[:, :, None]                                   # (B, nc, t, H)
    m_t = torch.clamp(torch.maximum(torch.amax(b, dim=3), c_t), min=NEG)
    w = torch.exp(b - m_t[:, :, :, None])
    wqk = w * torch.einsum("bzthd,bzshd->bztsh", qc, kc)
    a_t = torch.exp(c_t - m_t)
    y = (torch.einsum("bztsh,bzshd->bzthd", wqk, vc)
         + a_t[..., None] * torch.einsum("bzthd,bzhde->bzthe", qc, C_in))
    qn = wqk.sum(dim=3) + a_t * torch.einsum("bzthd,bzhd->bzth", qc, n_in)
    h = y / torch.maximum(torch.abs(qn), torch.exp(-m_t))[..., None]
    return h.reshape(B, nc * chunk, H, Dh)[:, :S]
