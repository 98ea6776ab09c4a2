"""Mixture-of-Experts FFN with expert parallelism over the rail-ring
all-to-all axis (counterpart of ``repro/models/moe.py``; paper §3.3.4,
Figure 9, Table 4 "Expert (E)" row).

Two implementations, as in the reference:

* ``moe_ffn_dense``: capacity dispatch on one device, O(T*K + E*C*D); the
  oracle, and the one-process path.
* ``moe_ffn_ep``: expert parallelism on a ``DeviceMesh``, on rank-local
  tensors as in the reference's ``shard_map`` body: routing on the rank's
  tokens, an all-to-all over the EP axis (dispatch), the expert FFN on the
  rank's E/|ep| experts and F/|tp| columns with its partial sums reduced
  over the TP axis, the reverse all-to-all (combine).  With
  ``token_scatter`` each TP rank dispatches 1/|tp| of every expert queue
  and the queues are re-gathered on the TP axis, so the all-to-all moves
  1/|tp| of the bytes.  Its aux is the rank's own: the caller averages
  the layers' sum over the batch axes once (``aux_mean``), where the
  reference's ``pmean`` runs in every layer (the mean is linear).

Router: softmax top-k with the aux load-balancing loss (paper §A.4
Listing 1: ``aux_loss``, coeff 0.01).  Top-k ties go to the lower expert
index, as ``jax.lax.top_k`` (a stable descending sort, not ``torch.topk``,
which promises no order).  The capacity is the reference's Python
expression, ``round`` half to even included (``capacity``).

Each collective goes through ``collectives.autograd``, so the backward
issues the transposed collective and the byte ledger records both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..collectives.autograd import (
    all_to_all, copy_to, gather, gather_whole, reduce_from, reduce_scatter,
)
from ..collectives.schedules import all_reduce_axis, axis_size
from . import common as C
from .common import DTypes, Params


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert intermediate
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01
    num_shared_experts: int = 0
    router_dtype: Any = torch.float32
    ep_axis: str = "data"      # mesh axis carrying expert parallelism
    token_scatter: bool = False  # shard expert queues over TP (see moe_ffn_ep)


@dataclasses.dataclass(frozen=True)
class EPGroup:
    """Where a rank's MoE layers run expert-parallel: the mesh with the EP
    axis, the batch axes of size > 1 that ``aux`` is averaged over, and the
    TP axis that splits the experts' F dim (None: each rank runs its
    experts whole)."""
    mesh: DeviceMesh
    batch_axes: Tuple[str, ...]
    tp: Optional[C.TP]


def init_moe(gen, cfg: MoEConfig, dt: DTypes, device) -> Params:
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    p: Params = {
        "router": C.init_linear(gen, D, E, dt, device),
        "wi": C.trunc_normal(gen, (E, D, F), s_in, dt.param, device),
        "wg": C.trunc_normal(gen, (E, D, F), s_in, dt.param, device),
        "wo": C.trunc_normal(gen, (E, F, D), s_out, dt.param, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = C.init_swiglu(gen, D, F * cfg.num_shared_experts, dt, device)
    return p


def moe_specs(cfg: MoEConfig) -> Params:
    p: Params = {
        "router": C.linear_specs((None, None)),
        "wi": ("expert", None, "mlp"),
        "wg": ("expert", None, "mlp"),
        "wo": ("expert", "mlp", None),
    }
    if cfg.num_shared_experts:
        p["shared"] = C.swiglu_specs()
    return p


# ---------------------------------------------------------------------------
# Routing (both paths; on the tokens a rank holds)
# ---------------------------------------------------------------------------


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert: the reference's expression, with Python's ``round``
    (half to even: 2.5 -> 2), which ``torch.round`` or floor(x + 0.5) would
    not reproduce."""
    return int(max(1, round(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts)))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index first (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _scatter_slots(slot: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros(n + 1).at[slot].set(values)[:-1]``: slot ``n`` is the
    dumpster, the only index that repeats, and is cut off."""
    buf = torch.zeros((n + 1, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return buf.index_put((slot,), values)[:-1]


@dataclasses.dataclass(frozen=True)
class Routing:
    """One routing call, per assignment (token t's k-th choice, (T, K)):
    ``slot`` its place in the flattened (E, C) expert queues, or E * C (the
    dumpster) where its expert's queue is full; ``gate`` its renormalised
    gate, 0 where dropped; ``experts`` its expert.  The reference keeps the
    per-slot inverse (``src_token``, ``slot_gate``, ``slot_valid``)."""
    slot: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    experts: torch.Tensor
    num_experts: int
    capacity: int


def _route(router_w: torch.Tensor, cfg: MoEConfig, xt: torch.Tensor, dt: DTypes,
           cap: int) -> Routing:
    """Top-k routing of the tokens ``xt`` (T, D) into queues of ``cap``
    slots an expert."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    dev = xt.device
    logits = torch.matmul(xt, dt.c(router_w)).to(cfg.router_dtype)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                           # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(0)
    ce = torch.bincount(gate_idx.reshape(-1), minlength=E).to(cfg.router_dtype) / (T * K)
    aux = cfg.aux_loss_coeff * E * torch.sum(me * ce)

    # position-in-expert by a stable sort (the reference's, not a one-hot cumsum)
    flat_e = gate_idx.reshape(-1)                                   # (T*K,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_sorted = torch.arange(T * K, device=dev) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)
    keep = (pos < cap).reshape(T, K)
    slot = torch.where(keep, (flat_e * cap + pos).reshape(T, K), E * cap)  # dumpster
    return Routing(slot, gate_vals * keep, aux, gate_idx, E, cap)


def _expert_ffn(expert_in: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert's queue: (E, C, D) -> (E, C, D) (the
    reference's einsums, as batched products)."""
    h = torch.nn.functional.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wi)
    return torch.bmm(h, wo)


# Dispatch and combine move rows between tokens and expert slots without an
# accumulating scatter: a slot holds at most one assignment, so each is a
# plain scatter one way and a gather the other, forward and backward.  The
# reference's ``xt[src_token]`` and ``.at[src_token].add`` have, as
# gradient or forward, a scatter-add into token rows, which on the card
# adds with atomics (in bf16 the rounding then changes from run to run) or
# sorts runs of one index (the empty slots all name token 0: ~13 ms a
# moonshot prefill layer).


def _dispatch(xt: torch.Tensor, r: Routing) -> torch.Tensor:
    """The expert queues (E, C, D): each kept assignment's token row in its
    slot, zeros in the empty slots (the reference's ``xt[src_token] *
    slot_valid``).  The gradient gathers the slots back and sums a token's K
    rows."""
    T, D = xt.shape
    K = r.slot.shape[1]
    rows = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    queues = _scatter_slots(r.slot.reshape(-1), rows, r.num_experts * r.capacity)
    return queues.reshape(r.num_experts, r.capacity, D)


class _Combine(torch.autograd.Function):
    """out[t] = sum_k gate[t, k] * rows[slot[t, k]]: the reference's
    ``zeros_like(xt).at[src_token].add(expert_out * gate)`` gathered per
    token; a dropped assignment reads the zero row past the end.  A row is
    read by at most one assignment, so the backward writes each row once."""

    @staticmethod
    def forward(ctx, rows, gate, slot):
        picked = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])[slot]   # (T, K, D)
        ctx.save_for_backward(picked, gate, slot)
        ctx.rows = rows.shape[0]
        return (picked * gate[..., None]).sum(1)

    @staticmethod
    def backward(ctx, g):
        picked, gate, slot = ctx.saved_tensors
        d_gate = (picked * g[:, None, :]).sum(-1)
        d_rows = _scatter_slots(slot.reshape(-1), (g[:, None, :] * gate[..., None]).flatten(0, 1),
                                ctx.rows)
        return d_rows, d_gate, None


def _combine(xt: torch.Tensor, expert_out: torch.Tensor, r: Routing) -> torch.Tensor:
    """Each token's K expert outputs (E, C, D), weighted by their gates."""
    return _Combine.apply(expert_out.reshape(-1, xt.shape[1]), r.gate.to(xt.dtype), r.slot)


# ---------------------------------------------------------------------------
# Dense / oracle path
# ---------------------------------------------------------------------------


def moe_ffn_dense(p: Params, cfg: MoEConfig, x: torch.Tensor,
                  dt: DTypes) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    r = _route(p["router"]["w"], cfg, xt, dt, capacity(cfg, B * S))
    expert_out = _expert_ffn(_dispatch(xt, r), dt.c(p["wi"]), dt.c(p["wg"]), dt.c(p["wo"]))
    out = _combine(xt, expert_out, r)
    if cfg.num_shared_experts:
        out = out + C.swiglu(p["shared"], xt, dt)
    return out.reshape(B, S, D), r.aux.to(torch.float32)


# ---------------------------------------------------------------------------
# Expert-parallel path (all-to-all over the EP axis)
# ---------------------------------------------------------------------------


def moe_ffn_ep(p: Params, cfg: MoEConfig, x: torch.Tensor, dt: DTypes,
               ep: EPGroup) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: the rank's rows (B_local, S, D), whole over the TP axis; ``p``'s
    expert leaves are the rank's (E/|ep|, D, F/|tp|) / (E/|ep|, F/|tp|, D)
    blocks, the router whole.  Returns the rank's rows and the aux of its
    tokens, which ``aux_mean`` averages over ``ep.batch_axes``."""
    B, S, D = x.shape
    E = cfg.num_experts
    mesh, tp = ep.mesh, ep.tp
    n_ep = axis_size(mesh, cfg.ep_axis)
    if E % n_ep:
        raise ValueError(f"{E} experts do not split over {cfg.ep_axis!r} ({n_ep}): "
                         "the reference's moe_ffn_ep asserts E % ep == 0")
    xt = x.reshape(B * S, D)
    cap = capacity(cfg, B * S)
    if tp is not None:
        cap = -(-cap // tp.size) * tp.size
    r = _route(p["router"]["w"], cfg, xt, dt, cap)
    expert_in = _dispatch(xt, r)
    scatter = tp is not None and cfg.token_scatter
    if tp is not None:
        # the F-split FFN (and, scattered, each rank's slice) gives each TP
        # rank a part of the queue's gradient: summed here
        expert_in = copy_to(expert_in, tp.mesh, tp.axis)
    if scatter:
        n = cap // tp.size
        expert_in = expert_in.narrow(1, tp.rank * n, n)
    expert_in = all_to_all(expert_in, mesh, cfg.ep_axis, 0, 1)     # (E/ep, ep*C, D)
    if scatter:
        expert_in = gather(expert_in, mesh, tp.axis, 1)
    out_p = _expert_ffn(expert_in, dt.c(p["wi"]), dt.c(p["wg"]), dt.c(p["wo"])).to(xt.dtype)
    if scatter:
        out_p = reduce_scatter(out_p, mesh, tp.axis, 1)
    elif tp is not None:
        out_p = reduce_from(out_p, mesh, tp.axis)
    expert_out = all_to_all(out_p, mesh, cfg.ep_axis, 1, 0)         # (E, C(/tp), D)
    if scatter:
        expert_out = gather_whole(expert_out, mesh, tp.axis, 1)
    out = _combine(xt, expert_out, r)
    if cfg.num_shared_experts:
        out = out + C.swiglu(p["shared"], xt, dt)
    return out.reshape(B, S, D), r.aux.to(torch.float32)


def aux_mean(aux: torch.Tensor, ep: EPGroup) -> torch.Tensor:
    """The reference's ``pmean`` of aux over ``ep.batch_axes``, on the
    rank's aux (one layer's or the layers' sum): the mean on every rank, its
    gradient this rank's share of the mean's, as ``ModelZoo.loss`` takes a
    loss."""
    if not ep.batch_axes:
        return aux
    share = aux / axis_size(ep.mesh, ep.batch_axes)
    return all_reduce_axis(share.detach(), ep.mesh, ep.batch_axes) + (share - share.detach())


def moe_ffn(p: Params, cfg: MoEConfig, x: torch.Tensor, dt: DTypes,
            ep: Optional[EPGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel when the rank computes on a mesh with the EP axis
    (``ep``), as the reference does when a mesh is current; dense
    otherwise."""
    if ep is None:
        return moe_ffn_dense(p, cfg, x, dt)
    return moe_ffn_ep(p, cfg, x, dt, ep)
