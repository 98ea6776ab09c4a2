"""State-space and recurrent blocks (counterpart of ``repro/models/ssm.py``):
Mamba2 (SSD) and xLSTM (mLSTM, sLSTM).

Each block has a full-sequence form (``state=None``: prefill / training) and
a recurrent form over a carried state (decode).  Where the reference's
full-sequence forms call the chunked jnp scans (``_ssd_chunked``,
``_mlstm_chunked``), these call the port's ops, which compute the same
function: the hand-written CUDA kernel on the card (``kernels/ssd``,
``kernels/mlstm``), the chunked plain version on the CPU.  Both scans run in
f32, as in the reference.  sLSTM is a plain loop over time, not a kernel.

All shapes batch-first: x (B, S, D).

``*_specs`` name the leaves' logical axes as the reference's.  With a
``tp`` (``common.TP``) the full-sequence forms run a rank's H/tp heads, as
the reference's GSPMD step computes them on a "model" axis: Mamba2 takes
the whole ``in_proj`` / conv leaves (their "mlp" blocks cut the
concatenated ``[z, x, B, C, dt]`` columns across heads) and picks its
heads' columns and the shared B and C, the gated RMSNorm sums its squares
over the ranks, and ``out_proj`` is row-parallel; the mLSTM and sLSTM take
their column blocks of the head projections, their heads' columns of the
whole gates ``wi`` / ``wf``, and ``out`` row-parallel.  The recurrent forms
(decode) run whole.

With an ``sp`` (``common.TP``; sequence parallelism over "model", x holding
the rank's S/n positions) the full-sequence forms gather the positions at
entry (``common.seq_gather``), so the scan, the causal conv's zero padding
and the kernels' inputs are those of the uncut sequence, and return the
rank's positions (``common.seq_scatter``): with ``tp`` the out-projection's
partial sums are reduce-scattered over the positions in place of the
all-reduce; without it the block runs whole and each rank keeps its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..collectives.autograd import copy_to, reduce_from
from ..kernels.mlstm.ops import mlstm as mlstm_op
from ..kernels.mlstm.ref import NEG, mlstm_step
from ..kernels.ssd.ops import ssd as ssd_op
from .common import (
    TP, DTypes, Params, init_linear, init_rmsnorm, linear, linear_specs, rmsnorm, rmsnorm_specs,
    seq_gather, seq_scatter, trunc_normal,
)


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2(gen, cfg: Mamba2Config, dt: DTypes, device) -> Params:
    D, Din, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    # in_proj -> [z (Din), x (Din), B (N), C (N), dt (H)]
    return {
        "in_proj": init_linear(gen, D, 2 * Din + 2 * N + H, dt, device),
        "conv_w": trunc_normal(gen, (cfg.d_conv, Din + 2 * N), 0.5, dt.param, device),
        "conv_b": torch.zeros((Din + 2 * N,), dtype=dt.param, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).to(dt.param),
        "D": torch.ones((H,), dtype=dt.param, device=device),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H, **f32))).to(dt.param),
        "norm": init_rmsnorm(Din, dt, device),
        "out_proj": init_linear(gen, Din, D, dt, device),
    }


def mamba2_specs(cfg: Mamba2Config) -> Params:
    return {
        "in_proj": linear_specs(("fsdp", "mlp")),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": rmsnorm_specs(),
        "out_proj": linear_specs(("mlp", "fsdp")),
    }


def _span(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, device=device)


def _mamba2_local(p: Params, cfg: Mamba2Config, tp: TP) -> Params:
    """Rank ``tp.rank``'s view of a Mamba2 block: its H/tp heads' columns of
    the whole ``in_proj`` and conv leaves (z, x and dt of its heads, B and C
    whole), of ``A_log`` / ``D`` / ``dt_bias`` and of the norm's scale;
    ``out_proj`` is already its rows."""
    Din, N, H = cfg.d_inner // tp.size, cfg.d_state, cfg.n_heads // tp.size
    r, dev = tp.rank, p["A_log"].device
    cols = torch.cat([_span(r * Din, Din, dev), _span(cfg.d_inner + r * Din, Din, dev),
                      _span(2 * cfg.d_inner, 2 * N, dev),
                      _span(2 * cfg.d_inner + 2 * N + r * H, H, dev)])
    conv = torch.cat([_span(r * Din, Din, dev), _span(cfg.d_inner, 2 * N, dev)])
    heads = slice(r * H, (r + 1) * H)
    return {
        "in_proj": {"w": p["in_proj"]["w"].index_select(1, cols)},
        "conv_w": p["conv_w"].index_select(1, conv),
        "conv_b": p["conv_b"].index_select(0, conv),
        "A_log": p["A_log"][heads], "D": p["D"][heads], "dt_bias": p["dt_bias"][heads],
        "norm": {"scale": p["norm"]["scale"][r * Din:(r + 1) * Din]},
        "out_proj": p["out_proj"],
    }


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, d: int, tp: TP,
                eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm`` over the whole d_inner (``d``) of a rank's y slice: the
    squares summed over ``tp``.  Each rank normalises its own slice with the
    sum, so the sum's gradient is summed over ``tp`` too (``copy_to``)."""
    y32 = y.to(torch.float32)
    ss = reduce_from(torch.sum(y32 * y32, dim=-1, keepdim=True), tp.mesh, tp.axis)
    var = copy_to(ss, tp.mesh, tp.axis) / d
    return (y32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(y.dtype)


def _pad_seq(a: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """Append ``n`` positions along dim 1 of a (B, S, ...) tensor."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, n), value=value)


def _enter(x: torch.Tensor, tp: Optional[TP], sp: Optional[TP]) -> torch.Tensor:
    """x entering a full-sequence block: the positions gathered over ``sp``,
    else, with ``tp``, the replicated x whose gradient is summed over it."""
    if sp is not None:
        return seq_gather(x, sp, tp is not None)
    return copy_to(x, tp.mesh, tp.axis) if tp is not None else x


def _leave(p: Params, y: torch.Tensor, dt: DTypes, tp: Optional[TP],
           sp: Optional[TP]) -> torch.Tensor:
    """The out-projection ``p`` of y: row-parallel with ``tp`` (its partial
    sums all-reduced, or reduce-scattered over the positions with ``sp``);
    at the rank's positions with ``sp``."""
    out = linear(p, y, dt)
    if sp is not None:
        return seq_scatter(out, sp, tp is not None)
    return reduce_from(out, tp.mesh, tp.axis) if tp is not None else out


def mamba2(
    p: Params, cfg: Mamba2Config, x: torch.Tensor, dt: DTypes,
    state: Optional[Dict[str, torch.Tensor]] = None, tp: Optional[TP] = None,
    sp: Optional[TP] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Mamba2 block.  ``state`` (decode): {"conv": (B, d_conv-1, Dc),
    "ssm": (B, H, P, N)}; x then has one position, as in the reference
    (whose state branch reads position 0 only).  ``tp`` (no ``state``): a
    rank's heads; ``sp`` (no ``state``): x holds the rank's positions (see
    the module docstring)."""
    if state is not None and (tp is not None or sp is not None):
        raise ValueError("the Mamba2 state step runs whole, not split over heads or positions")
    Din, N, H, Pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    if tp is not None:
        p = _mamba2_local(p, cfg, tp)
        Din, H = Din // tp.size, H // tp.size
    x = _enter(x, tp, sp)
    Bsz, S, _ = x.shape
    zxbcdt = linear(p["in_proj"], x, dt)
    z, xr, Bc, Cc, dtg = torch.split(zxbcdt, [Din, Din, N, N, H], dim=-1)
    conv_in = torch.cat([xr, Bc, Cc], dim=-1)             # (B, S, Din + 2N)
    w = dt.c(p["conv_w"])                                 # (K, Dc)
    K = w.shape[0]
    if state is not None:
        if S != 1:
            raise ValueError(f"the Mamba2 state step takes one token, got {S}")
        hist = torch.cat([state["conv"], conv_in], dim=1)  # (B, K-1+S, Dc)
        new_conv = hist[:, -(K - 1):, :]
        conv_out = torch.einsum("bkc,kc->bc", hist[:, -K:, :], w)[:, None, :] + p["conv_b"].to(x.dtype)
    else:
        padded = torch.cat([conv_in.new_zeros((Bsz, K - 1, conv_in.shape[-1])), conv_in], dim=1)
        conv_out = padded[:, 0:S, :] * w[0][None, None, :]
        for i in range(1, K):
            conv_out = conv_out + padded[:, i:i + S, :] * w[i][None, None, :]
        conv_out = conv_out + p["conv_b"].to(x.dtype)
    conv_out = F.silu(conv_out)
    xr, Bc, Cc = torch.split(conv_out, [Din, N, N], dim=-1)
    xh = xr.reshape(Bsz, -1, H, Pd)
    dtg_sp = F.softplus(dtg.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))           # (H,) negative
    if state is not None:
        # single-step recurrence
        dA = torch.exp(dtg_sp[:, 0] * A[None, :])          # (B, H)
        Bx = torch.einsum("bn,bhp,bh->bhpn", Bc[:, 0].to(torch.float32),
                          xh[:, 0].to(torch.float32), dtg_sp[:, 0])
        new_ssm = state["ssm"] * dA[:, :, None, None] + Bx
        y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].to(torch.float32), new_ssm)
        y = y[:, None].to(x.dtype)
        new_state = {"conv": new_conv, "ssm": new_ssm}
    else:
        chunk = min(cfg.chunk, S)
        padlen = (-S) % chunk
        if padlen:
            xh, dtg_sp, Bc, Cc = (_pad_seq(a, padlen) for a in (xh, dtg_sp, Bc, Cc))
        y = ssd_op(xh.to(torch.float32), dtg_sp, Bc.to(torch.float32), Cc.to(torch.float32),
                   A, chunk)
        y = y[:, :S].to(x.dtype)
        new_state = None
    y = y + xh[:, :S].to(x.dtype) * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, Din)
    if tp is not None:
        y = _gated_norm(p["norm"]["scale"], y, cfg.d_inner, tp) * F.silu(z)
    else:
        y = rmsnorm(p["norm"], y) * F.silu(z)
    return _leave(p["out_proj"], y, dt, tp, sp), new_state


def mamba2_init_state(cfg: Mamba2Config, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunkwise) + sLSTM (sequential)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    heads: int = 4
    chunk: int = 64
    conv_kernel: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads


def init_mlstm(gen, cfg: XLSTMConfig, dt: DTypes, device) -> Params:
    D, H, Dh = cfg.d_model, cfg.heads, cfg.head_dim
    return {
        "wq": init_linear(gen, D, D, dt, device),
        "wk": init_linear(gen, D, D, dt, device),
        "wv": init_linear(gen, D, D, dt, device),
        "wi": init_linear(gen, D, H, dt, device),      # input gate (per head)
        "wf": init_linear(gen, D, H, dt, device),      # forget gate
        "wo_gate": init_linear(gen, D, D, dt, device),
        "norm": init_rmsnorm(Dh, dt, device),
        "out": init_linear(gen, D, D, dt, device),
    }


def mlstm_specs(cfg: XLSTMConfig) -> Params:
    return {
        "wq": linear_specs(("fsdp", "heads")),
        "wk": linear_specs(("fsdp", "heads")),
        "wv": linear_specs(("fsdp", "heads")),
        "wi": linear_specs(("fsdp", None)),
        "wf": linear_specs(("fsdp", None)),
        "wo_gate": linear_specs(("fsdp", "heads")),
        "norm": rmsnorm_specs(),
        "out": linear_specs(("heads", "fsdp")),
    }


def _heads_local(p: Params, cfg: XLSTMConfig, x: torch.Tensor, tp: Optional[TP],
                 sp: Optional[TP]):
    """(p, x, heads) as a rank computes an xLSTM block: with ``tp`` the
    whole gates ``wi`` / ``wf`` cut to its heads' columns; x entering the
    block (``_enter``)."""
    x = _enter(x, tp, sp)
    if tp is None:
        return p, x, cfg.heads
    H = cfg.heads // tp.size
    cols = slice(tp.rank * H, (tp.rank + 1) * H)
    p = {**p, "wi": {"w": p["wi"]["w"][:, cols]}, "wf": {"w": p["wf"]["w"][:, cols]}}
    return p, x, H


def mlstm(
    p: Params, cfg: XLSTMConfig, x: torch.Tensor, dt: DTypes,
    state: Optional[Dict[str, torch.Tensor]] = None, tp: Optional[TP] = None,
    sp: Optional[TP] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """mLSTM with exponential gating and matrix memory (xLSTM section 2.3).
    Without ``state``: the chunkwise form over the whole sequence (padded to
    a multiple of the chunk with an input gate of -1e30).  With ``state``
    {"C", "n", "m"}: the recurrence over the S new positions, dividing by
    max(|q.n|, 1) where the chunkwise form divides by max(|q.n|, exp(-m)) (a
    reference quirk, kept).  ``tp``: a rank's heads, ``sp``: x holds the
    rank's positions (no ``state``)."""
    if state is not None and (tp is not None or sp is not None):
        raise ValueError("the mLSTM recurrence runs whole, not split over heads or positions")
    p, x, H = _heads_local(p, cfg, x, tp, sp)
    B, S, _ = x.shape
    Dh = cfg.head_dim
    D = H * Dh
    q = linear(p["wq"], x, dt).reshape(B, S, H, Dh) / math.sqrt(Dh)
    k = linear(p["wk"], x, dt).reshape(B, S, H, Dh)
    v = linear(p["wv"], x, dt).reshape(B, S, H, Dh)
    i_gate = linear(p["wi"], x, dt).to(torch.float32)             # (B, S, H)
    f_gate = linear(p["wf"], x, dt).to(torch.float32)
    logf = F.logsigmoid(f_gate)                                    # (B, S, H)
    if state is not None:
        C, n, m = state["C"], state["n"], state["m"]   # (B,H,Dh,Dh), (B,H,Dh), (B,H)
        ys = []
        for t in range(S):
            qt, kt, vt = (a[:, t].to(torch.float32) for a in (q, k, v))
            h, C, n, m = mlstm_step(C, n, m, qt, kt, vt, i_gate[:, t], logf[:, t], floor=1.0)
            ys.append(h)
        y = torch.stack(ys, dim=1).to(x.dtype)                     # (B, S, H, Dh)
        new_state = {"C": C, "n": n, "m": m}
    else:
        chunk = min(cfg.chunk, S)
        pad = (-S) % chunk
        qf, kf, vf, lf = (a.to(torch.float32) for a in (q, k, v, logf))
        ig = i_gate
        if pad:
            qf, kf, vf, lf = (_pad_seq(a, pad) for a in (qf, kf, vf, lf))
            ig = _pad_seq(ig, pad, NEG)
        y = mlstm_op(qf, kf, vf, ig, lf, chunk)[:, :S].to(x.dtype)
        new_state = None
    y = rmsnorm(p["norm"], y)
    o = torch.sigmoid(linear(p["wo_gate"], x, dt)).reshape(B, S, H, Dh)
    y = (y * o).reshape(B, S, D)
    return _leave(p["out"], y, dt, tp, sp), new_state


def mlstm_init_state(cfg: XLSTMConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    H, Dh = cfg.heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, Dh, Dh), **f32),
        "n": torch.zeros((batch, H, Dh), **f32),
        "m": torch.full((batch, H), NEG, **f32),
    }


def init_slstm(gen, cfg: XLSTMConfig, dt: DTypes, device) -> Params:
    D, H = cfg.d_model, cfg.heads
    return {
        "wz": init_linear(gen, D, D, dt, device),
        "wi": init_linear(gen, D, H, dt, device),
        "wf": init_linear(gen, D, H, dt, device),
        "wo_gate": init_linear(gen, D, D, dt, device),
        "norm": init_rmsnorm(cfg.head_dim, dt, device),
        "out": init_linear(gen, D, D, dt, device),
    }


def slstm_specs(cfg: XLSTMConfig) -> Params:
    return {
        "wz": linear_specs(("fsdp", "heads")),
        "wi": linear_specs(("fsdp", None)),
        "wf": linear_specs(("fsdp", None)),
        "wo_gate": linear_specs(("fsdp", "heads")),
        "norm": rmsnorm_specs(),
        "out": linear_specs(("heads", "fsdp")),
    }


def slstm(
    p: Params, cfg: XLSTMConfig, x: torch.Tensor, dt: DTypes,
    state: Optional[Dict[str, torch.Tensor]] = None, tp: Optional[TP] = None,
    sp: Optional[TP] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """sLSTM (xLSTM section 2.2): scalar memory per head dim with
    exponential gating; a sequential loop over time (from zeros without
    ``state``, from it with one; the new state is returned with one).
    ``tp``: a rank's heads, ``sp``: x holds the rank's positions (no
    ``state``)."""
    if state is not None and (tp is not None or sp is not None):
        raise ValueError("the sLSTM recurrence runs whole, not split over heads or positions")
    p, x, H = _heads_local(p, cfg, x, tp, sp)
    B, S, _ = x.shape
    Dh = cfg.head_dim
    D = H * Dh
    z = torch.tanh(linear(p["wz"], x, dt)).reshape(B, S, H, Dh).to(torch.float32)
    i_gate = linear(p["wi"], x, dt).to(torch.float32)
    f_gate = linear(p["wf"], x, dt).to(torch.float32)
    logf = F.logsigmoid(f_gate)
    if state is None:
        init = slstm_init_state(dataclasses.replace(cfg, heads=H, d_model=D), B, x.device)
        c, n, m = init["c"], init["n"], init["m"]
    else:
        c, n, m = state["c"], state["n"], state["m"]   # (B,H,Dh), (B,H), (B,H)
    hs = []
    for t in range(S):
        it, lf = i_gate[:, t], logf[:, t]
        m_new = torch.maximum(lf + m, it)
        fdec = torch.exp(lf + m - m_new)
        iamp = torch.exp(it - m_new)
        c = c * fdec[..., None] + iamp[..., None] * z[:, t]
        n = n * fdec + iamp
        hs.append(c / torch.clamp(n, min=1.0)[..., None])
        m = m_new
    y = torch.stack(hs, dim=1).to(x.dtype)                         # (B, S, H, Dh)
    y = rmsnorm(p["norm"], y)
    o = torch.sigmoid(linear(p["wo_gate"], x, dt)).reshape(B, S, H, Dh)
    y = (y * o).reshape(B, S, D)
    out = _leave(p["out"], y, dt, tp, sp)
    new_state = {"c": c, "n": n, "m": m} if state is not None else None
    return out, new_state


def slstm_init_state(cfg: XLSTMConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    H, Dh = cfg.heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, H, Dh), **f32),
        "n": torch.zeros((batch, H), **f32),
        "m": torch.full((batch, H), NEG, **f32),
    }
