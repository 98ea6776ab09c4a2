"""Plain PyTorch versions of the Mamba2 SSD scan (counterpart of
``repro/kernels/ssd/ref.py`` and of ``repro/models/ssm._ssd_chunked``).

    y_t = C_t . h_t,   h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t

per head, with h (P, N), A a negative scalar per head, and B, C shared by
all heads.

* ``ssd_ref``: the sequential scan, one step per position (the oracle, and
  the function whose gradient ``ops.ssd`` takes);
* ``ssd_chunked_ref``: the chunked matmul form the kernel computes, from a
  zero state, returning the final state too; the wrapper runs it on CPU
  tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_ref(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H) post-softplus
    Bm: torch.Tensor,     # (B, S, N)
    Cm: torch.Tensor,     # (B, S, N)
    A: torch.Tensor,      # (H,) negative decay rates
) -> torch.Tensor:
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])                                   # (B, H)
        inject = torch.einsum("bn,bhp,bh->bhpn", Bm[:, t], x[:, t], dt[:, t])
        h = h * dA[:, :, None, None] + inject
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1)                                                # (B, S, H, P)


def ssd_chunked_ref(
    xh: torch.Tensor, dtg: torch.Tensor, B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan in the chunked matmul form.

    xh (b, S, H, P), dtg (b, S, H), B/C (b, S, N), A (H,); S a multiple of
    ``chunk``.  Returns (y (b, S, H, P), final_state (b, H, P, N)).
    """
    b, S, H, Pd = xh.shape
    N = B.shape[-1]
    nc = S // chunk
    xc = xh.reshape(b, nc, chunk, H, Pd)
    dc = dtg.reshape(b, nc, chunk, H)
    Bc = B.reshape(b, nc, chunk, N)
    Cc = C.reshape(b, nc, chunk, N)
    dA = dc * A[None, None, None, :]                      # (b, nc, c, H) negative
    cum = torch.cumsum(dA, dim=2)                         # within-chunk cumsum
    # intra-chunk (causal): y_intra[t] = sum_{s<=t} exp(cum t - cum s) C_t.B_s x_s dt_s
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b, nc, t, s, H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    CB = torch.einsum("bztn,bzsn->bzts", Cc, Bc)            # (b, nc, t, s)
    M = CB[..., None] * L                                   # (b, nc, t, s, H)
    xdt = xc * dc[..., None]                                # (b, nc, s, H, P)
    y_intra = torch.einsum("bztsh,bzshp->bzthp", M, xdt)
    # chunk states: state_z = sum_s exp(cum end - cum s) B_s x_s dt_s
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (b, nc, c, H)
    state_contrib = torch.einsum("bzsn,bzshp,bzsh->bzhpn", Bc, xdt, decay_to_end)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b, nc, H)
    # inter-chunk recurrence over the nc chunks; keep each chunk's state in
    state = torch.zeros((b, H, Pd, N), dtype=xh.dtype, device=xh.device)
    states_before = []
    for z in range(nc):
        states_before.append(state)
        state = state * chunk_decay[:, z, :, None, None] + state_contrib[:, z]
    states_before = torch.stack(states_before, dim=1)      # (b, nc, H, P, N)
    # inter-chunk contribution: y_inter[t] = C_t . (exp(cum t) state_in)
    decay_from_start = torch.exp(cum)                       # (b, nc, c, H)
    y_inter = torch.einsum("bztn,bzhpn,bzth->bzthp", Cc, states_before, decay_from_start)
    y = (y_intra + y_inter).reshape(b, S, H, Pd)
    return y, state
