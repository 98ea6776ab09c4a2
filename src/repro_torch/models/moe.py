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
  The EP axis is any mesh axis (``cfg.ep_axis``).  The reference's
  ``shard_map`` takes the tokens over ("pod", EP axis); the step's rows
  are cut over ("pod", "data"), so with another EP axis the rows (and the
  router's logits, so that the router's gradient stays the step's share)
  are regrouped onto the EP axis and back (``collectives.autograd.regroup``),
  the ranks along "data" then computing the same thing, as the reference's
  do;
* ``moe_ffn_global``: a mesh without the EP axis (no "data" in it): the
  reference runs ``moe_ffn_dense`` under GSPMD over the global batch.  The
  rank gathers the hidden states over the batch axes (the gradient
  reduce-scattered), routes the global tokens with the global capacity,
  runs the experts (F split over "model" when the layout splits it, the
  partial sums all-reduced), and keeps its own rows.

Router: softmax top-k with the aux load-balancing loss (paper §A.4
Listing 1: ``aux_loss``, coeff 0.01).  Top-k ties go to the lower expert
index, as ``jax.lax.top_k`` (a stable descending sort, not ``torch.topk``,
which promises no order).  The capacity is the reference's Python
expression, ``round`` half to even included (``capacity``).

Each collective goes through ``collectives.autograd``, so the backward
issues the transposed collective and the byte ledger records both.

Tracing (``repro_torch.obs``): the routed parts run in ``moe.fwd.route``,
``moe.fwd.dispatch``, ``moe.fwd.experts`` and ``moe.fwd.combine`` spans and
the shared SwiGLU in ``moe.fwd.shared``; each routing call adds a
``moe.routing`` counter (T * K assignments, E * C slots, and the kept
assignments, reduced from the choices' counts only when the counter is
read); ``moe_ffn`` puts the layer's backward in a ``moe.bwd`` span, from
the gradient reaching its output to it leaving its input.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..collectives.autograd import (
    all_to_all, copy_to, gather, gather_whole, reduce_from, reduce_scatter, regroup,
)
from ..collectives.schedules import all_reduce_axis, axis_size
from ..obs import NULL_SPAN, get_tracer
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
    """Where a rank's MoE layers run: the mesh, the batch axes of size > 1
    that the tokens are cut over and ``aux`` is averaged over (the
    reference's ``batch_axes``, ("pod", EP axis)), the TP axis that splits
    the experts' F dim (None: each rank runs its experts whole), the EP
    axis (None: the mesh has none, and the layer runs dense over the
    global batch), and ``rows``, the axes that the rank's rows arrive cut
    over (None: ``batch_axes``)."""
    mesh: DeviceMesh
    batch_axes: Tuple[str, ...]
    tp: Optional[C.TP]
    axis: Optional[str] = "data"
    rows: Optional[Tuple[str, ...]] = None

    @property
    def row_axes(self) -> Tuple[str, ...]:
        return self.batch_axes if self.rows is None else self.rows


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


def router_logits(router_w: torch.Tensor, cfg: MoEConfig, xt: torch.Tensor,
                  dt: DTypes) -> torch.Tensor:
    return torch.matmul(xt, dt.c(router_w)).to(cfg.router_dtype)


def _route(router_w: torch.Tensor, cfg: MoEConfig, xt: torch.Tensor, dt: DTypes, cap: int,
           logits: Optional[torch.Tensor] = None) -> Routing:
    """Top-k routing of the tokens ``xt`` (T, D) into queues of ``cap``
    slots an expert; from their router ``logits`` (T, E) when given."""
    trc = get_tracer()
    with (trc.span("moe.fwd.route", cat="moe") if trc.enabled else NULL_SPAN):
        r, choices = _route_choices(router_w, cfg, xt, dt, cap, logits)
    if trc.enabled:
        trc.counter("moe.routing", assigned=r.slot.numel(), slots=r.num_experts * cap,
                    kept=functools.partial(_kept, choices, cap))
    return r


def _kept(choices: torch.Tensor, cap: int) -> int:
    """The assignments a routing kept: sum over experts of min(count, cap)."""
    return int(torch.clamp(choices, max=cap).sum().item())


def _route_choices(router_w: torch.Tensor, cfg: MoEConfig, xt: torch.Tensor, dt: DTypes,
                   cap: int, logits: Optional[torch.Tensor]) -> Tuple[Routing, torch.Tensor]:
    """``_route``'s routing and each expert's count of choices (E,)."""
    if logits is None:
        logits = router_logits(router_w, cfg, xt, dt)
    T = logits.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                           # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(0)
    # the choices' counts (bincount's, with a shape that needs no host read)
    choices = torch.zeros(E, dtype=cfg.router_dtype, device=dev).index_add_(
        0, gate_idx.reshape(-1), torch.ones(T * K, dtype=cfg.router_dtype, device=dev))
    ce = choices / (T * K)
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
    return Routing(slot, gate_vals * keep, aux, gate_idx, E, cap), choices


def _expert_ffn(expert_in: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert's queue: (E, C, D) -> (E, C, D) (the
    reference's einsums, as batched products)."""
    trc = get_tracer()
    with (trc.span("moe.fwd.experts", cat="moe") if trc.enabled else NULL_SPAN):
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
    trc = get_tracer()
    with (trc.span("moe.fwd.dispatch", cat="moe") if trc.enabled else NULL_SPAN):
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
    trc = get_tracer()
    with (trc.span("moe.fwd.combine", cat="moe") if trc.enabled else NULL_SPAN):
        return _Combine.apply(expert_out.reshape(-1, xt.shape[1]), r.gate.to(xt.dtype), r.slot)


def _shared(p: Params, xt: torch.Tensor, dt: DTypes) -> torch.Tensor:
    """The shared experts' SwiGLU of the tokens ``xt`` (T, D)."""
    trc = get_tracer()
    with (trc.span("moe.fwd.shared", cat="moe") if trc.enabled else NULL_SPAN):
        return C.swiglu(p["shared"], xt, dt)


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
        out = out + _shared(p, xt, dt)
    return out.reshape(B, S, D), r.aux.to(torch.float32)


# ---------------------------------------------------------------------------
# Expert-parallel path (all-to-all over the EP axis)
# ---------------------------------------------------------------------------


def moe_ffn_ep(p: Params, cfg: MoEConfig, x: torch.Tensor, dt: DTypes,
               ep: EPGroup) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: the rank's rows (B_local, S, D), cut over ``ep.row_axes`` and
    whole over the TP axis; ``p``'s expert leaves are the rank's
    (E/|ep|, D, F/|tp|) / (E/|ep|, F/|tp|, D) blocks, the router whole.
    Returns the rank's rows and the aux of the tokens it routed, which
    ``aux_mean`` averages over ``ep.batch_axes``."""
    B, S, D = x.shape
    E = cfg.num_experts
    mesh, tp = ep.mesh, ep.tp
    n_ep = axis_size(mesh, cfg.ep_axis)
    if E % n_ep:
        raise ValueError(f"{E} experts do not split over {cfg.ep_axis!r} ({n_ep}): "
                         "the reference's moe_ffn_ep asserts E % ep == 0")
    logits = router_logits(p["router"]["w"], cfg, x.reshape(B * S, D), dt)
    # the tokens as the reference's shard_map cuts them: over ("pod", EP axis)
    to_ep, back = [(0, ep.row_axes, ep.batch_axes)], [(0, ep.batch_axes, ep.row_axes)]
    xb = regroup(x, mesh, to_ep)
    logits = regroup(logits.reshape(B, S, E), mesh, to_ep)
    Bl = xb.shape[0]
    xt = xb.reshape(Bl * S, D)
    cap = capacity(cfg, Bl * S)
    if tp is not None:
        cap = -(-cap // tp.size) * tp.size
    r = _route(p["router"]["w"], cfg, xt, dt, cap, logits.reshape(Bl * S, E))
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
    out = regroup(_combine(xt, expert_out, r).reshape(Bl, S, D), mesh, back)
    return _with_shared(p, cfg, x, out, dt), r.aux.to(torch.float32)


def _with_shared(p: Params, cfg: MoEConfig, x: torch.Tensor, out: torch.Tensor,
                 dt: DTypes) -> torch.Tensor:
    """``out`` plus the shared experts' SwiGLU of the rank's rows ``x``."""
    if not cfg.num_shared_experts:
        return out
    B, S, D = x.shape
    return out + _shared(p, x.reshape(B * S, D), dt).reshape(B, S, D)


def moe_ffn_global(p: Params, cfg: MoEConfig, x: torch.Tensor, dt: DTypes,
                   ep: EPGroup) -> Tuple[torch.Tensor, torch.Tensor]:
    """A mesh without the EP axis: ``moe_ffn_dense`` over the global batch
    (the rows gathered over ``ep.row_axes``, the global capacity), the
    experts' F dim split over ``ep.tp`` when given; returns the rank's rows
    and the global aux (every rank's the same; ``aux_mean`` keeps it and
    gives each rank its share of the gradient)."""
    B, S, D = x.shape
    mesh, tp = ep.mesh, ep.tp
    xg = x
    for a in reversed(ep.row_axes):  # minor first: blocks in mesh order
        xg = gather(xg, mesh, a, 0)
    T = xg.shape[0] * S
    xt = xg.reshape(T, D)
    r = _route(p["router"]["w"], cfg, xt, dt, capacity(cfg, T))
    expert_in = _dispatch(xt, r)
    if tp is not None:
        expert_in = copy_to(expert_in, tp.mesh, tp.axis)
    expert_out = _expert_ffn(expert_in, dt.c(p["wi"]), dt.c(p["wg"]), dt.c(p["wo"])).to(xt.dtype)
    if tp is not None:
        expert_out = reduce_from(expert_out, tp.mesh, tp.axis)
    out = _combine(xt, expert_out, r).reshape(-1, S, D)
    if ep.row_axes:
        idx = 0
        for a in ep.row_axes:
            idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
        out = out.narrow(0, idx * B, B)
    return _with_shared(p, cfg, x, out, dt), r.aux.to(torch.float32)


def aux_mean(aux: torch.Tensor, ep: EPGroup) -> torch.Tensor:
    """The reference's ``pmean`` of aux over ``ep.batch_axes``, on the
    rank's aux (one layer's or the layers' sum): the mean on every rank, its
    gradient this rank's share of the mean's, as ``ModelZoo.loss`` takes a
    loss."""
    if not ep.batch_axes:
        return aux
    share = aux / axis_size(ep.mesh, ep.batch_axes)
    return all_reduce_axis(share.detach(), ep.mesh, ep.batch_axes) + (share - share.detach())


class _BwdSpan:
    """The ``moe.bwd`` span of one layer call's backward, opened once."""

    __slots__ = ("tracer", "opened")

    def __init__(self, tracer):
        self.tracer = tracer
        self.opened = False

    def open(self) -> None:
        self.tracer.begin("moe.bwd", cat="moe")
        self.opened = True

    def close(self) -> None:
        if self.opened:
            self.tracer.end("moe.bwd")
            self.opened = False


class _BwdClose(torch.autograd.Function):
    """Identity on the layer's input; its backward, once every gradient of
    the layer has reached the input, closes ``moe.bwd``.  It saves the
    input (which the router's product keeps anyway) for ``_BwdOpen`` to
    read: a save at the layer's start, where remat's early stop, which
    ends the recompute at the layer's last save, sees no new save."""

    @staticmethod
    def forward(ctx, x, span):
        ctx.save_for_backward(x)
        ctx.span = span
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.span.close()
        return g, None


class _BwdOpen(torch.autograd.Function):
    """Identity on the layer's output; its backward opens ``moe.bwd`` after
    reading ``_BwdClose``'s saved input (``close``, that node): under remat
    the read runs the layer's recompute, which so stays outside the span."""

    @staticmethod
    def forward(ctx, out, close, span):
        ctx.close = close
        ctx.span = span
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        _ = ctx.close.saved_tensors  # the read that runs remat's recompute
        ctx.span.open()
        return g, None, None


def moe_ffn(p: Params, cfg: MoEConfig, x: torch.Tensor, dt: DTypes,
            ep: Optional[EPGroup] = None, tracer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel when the rank computes on a mesh with the EP axis
    (``ep``), as the reference does when a mesh is current; dense over the
    global batch on a mesh without it; dense without a mesh.

    While ``tracer`` (default: ``get_tracer()``) is enabled and ``x`` takes
    a gradient, two identity nodes put the layer's backward in a ``moe.bwd``
    span.  They save a tensor, so a remat caller passes the tracer it had
    in the forward, which remat's recompute then sees too: the two must
    save as many tensors."""
    trc = get_tracer() if tracer is None else tracer
    if not (trc.enabled and x.requires_grad and torch.is_grad_enabled()):
        return _moe_ffn(p, cfg, x, dt, ep)
    span = _BwdSpan(trc)
    x = _BwdClose.apply(x, span)
    out, aux = _moe_ffn(p, cfg, x, dt, ep)
    return _BwdOpen.apply(out, x.grad_fn, span), aux


def _moe_ffn(p: Params, cfg: MoEConfig, x: torch.Tensor, dt: DTypes,
             ep: Optional[EPGroup]) -> Tuple[torch.Tensor, torch.Tensor]:
    if ep is None:
        return moe_ffn_dense(p, cfg, x, dt)
    if ep.axis is None:
        return moe_ffn_global(p, cfg, x, dt, ep)
    return moe_ffn_ep(p, cfg, x, dt, ep)
