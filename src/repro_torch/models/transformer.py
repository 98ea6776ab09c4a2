"""Decoder-only transformer LM, dense, MoE and vlm families (counterpart of
``repro/models/transformer.py``).

Covers qwen3-8b (qk-norm, untied lm_head), llama3.2-3b and granite-20b
(MQA), gemma3-4b (local:global sliding windows, switched per layer), the
vlm family's qwen2-vl-2b (M-RoPE over ``positions3``, prompts given as
``embeds``), and, with a ``"moe"`` block in place of the ``"ffn"`` one,
moonshot-v1-16b-a3b, qwen3-moe-235b-a22b and paper-llama3-moe
(``models/moe.py``).  Layers are stacked with a leading ``L`` dim, as in
the reference; a Python loop over that dim takes the place of
``lax.scan``.  With ``cfg.remat`` and gradients on, each layer runs under
``torch.utils.checkpoint`` (non-reentrant): nothing inside a layer is kept
for the backward, which recomputes it, as ``jax.checkpoint`` with
``nothing_saveable`` does in the reference.  Each layer returns its MoE
aux loss, summed over the layers as the reference's scan carry does (0
for the dense family).

API (used by serve and train):
    init(gen, cfg, device)                  -> params (ParamTree)
    param_specs(cfg) / cache_specs(cfg)     -> logical-axis spec trees
    forward(params, cfg, batch, plan=None)  -> (logits, aux_loss)
    init_cache(cfg, batch, cache_len, dev)  -> cache
    decode_step(params, cfg, cache, batch, plan=None) -> (logits, cache)

With a ``ShardPlan`` (``shard_plan(cfg, layout)``) the same functions run
on a rank's blocks of a sharded ``Layout`` (``parallel.sharding``), as the
reference's GSPMD step computes them: each layer's leaves are all-gathered
over their FSDP ("data") dims inside the layer's function (so under remat
the gather runs again in the backward, and only one layer is whole at a
time), and their gradients reduce-scattered.  On the "model" axis,
attention keeps the rank's heads (wq / wk / wv column-parallel, wo
row-parallel) when the heads divide it, else runs whole on every rank; KV
heads that do not divide it (granite's one) are computed whole from wk / wv
gathered over "model", and each rank attends with the KV heads its query
heads use.  The MLP splits its hidden dim when it divides; the embedding
and the logits split the vocab (``common.vocab_embed``); the logits stay
split (the loss reduces over "model", ``ModelZoo.loss``).  An MoE layer
runs expert-parallel over ``cfg.moe_ep_axis`` (``moe.moe_ffn_ep``): its
expert leaves are regrouped from their stored blocks into E/|ep| experts a
rank and, with TP, F/|model| columns (with the EP axis on "data", the
stored blocks themselves, never gathered); the tokens go to their experts
by an all-to-all over the EP axis.  On a mesh without the EP axis it runs
dense over the global batch (``moe.moe_ffn_global``).  The router passes
whole.  The layers' aux sum is averaged over the batch axes once
(``moe.aux_mean``).  Batch rows are the caller's: the step passes each
rank its rows, and the cache its rows, KV heads and positions.

Under the reference's ``seq -> "model"`` rule (``seq_plan``; every family)
a rank holds its block of S/|model| positions of every activation, as the
reference's ``("batch", "seq", ...)`` hints resolve: the weights are
gathered whole (their gradients summed over "model", ``_seq_weight``),
except that the embedding looks its rows up from the table's vocab blocks
(``common.seq_vocab_embed``) and the logits gather their weight inside a
checkpoint (``_seq_logits``); attention gathers K and V over "model" and
its queries start at ``rank * S/|model|``.  A block that mixes positions
otherwise (``_SEQ_GATHERED``: the MoE layer here, the hybrid's Mamba2 and
the xLSTM's mLSTM / sLSTM) gathers the positions over "model"
(``common.seq_gather``) and runs as it runs without the cut, on the same
tokens with the same weights, then returns the rank's positions
(``common.seq_scatter``).

The cache is ``{"k", "v": (L, B, cache_len, Hk, Dh), "index": int}``.
``index`` is a host int (the reference keeps a device scalar) so a decode
step needs no device sync.  ``decode_step`` writes the cache in place: the
reference donates its cache to the jitted step, and this is the
counterpart, so the cache passed in must not be used again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..collectives.autograd import copy_to, gather, gather_whole, regroup
from ..collectives.schedules import all_gather_axis
from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..obs import get_tracer
from ..parallel.sharding import Layout, dp_axes, entry_axes
from . import common as C
from .common import DTypes, Params, ParamTree
from .moe import EPGroup, MoEConfig, aux_mean, init_moe, moe_ffn, moe_specs

ATTN_IMPLS = ("ref", "flash")


def _dt(cfg: ModelConfig) -> DTypes:
    return DTypes(param=cfg.param_dtype, compute=cfg.compute_dtype)


def _attn_cfg(cfg: ModelConfig) -> C.AttnConfig:
    return C.AttnConfig(
        d_model=cfg.d_model,
        heads=cfg.heads,
        kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim,
        causal=True,
        window=cfg.sliding_window,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections,
    )


def _moe_cfg(cfg: ModelConfig) -> Optional[MoEConfig]:
    if cfg.moe is None:
        return None
    return MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.moe.d_ff,
        num_experts=cfg.moe.num_experts,
        top_k=cfg.moe.top_k,
        capacity_factor=cfg.moe.capacity_factor,
        aux_loss_coeff=cfg.moe.aux_loss_coeff,
        num_shared_experts=cfg.moe.num_shared_experts,
        ep_axis=cfg.moe_ep_axis,
        token_scatter=cfg.moe_token_scatter,
    )


def check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} is not one of {ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: ModelConfig, device) -> Params:
    dt = _dt(cfg)
    p: Params = {
        "ln1": C.init_rmsnorm(cfg.d_model, dt, device),
        "attn": C.init_attention(gen, _attn_cfg(cfg), dt, device),
        "ln2": C.init_rmsnorm(cfg.d_model, dt, device),
    }
    mcfg = _moe_cfg(cfg)
    if mcfg is not None:
        p["moe"] = init_moe(gen, mcfg, dt, device)
    else:
        p["ffn"] = C.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def _layer_specs(cfg: ModelConfig) -> Params:
    p: Params = {
        "ln1": C.rmsnorm_specs(),
        "attn": C.attention_specs(_attn_cfg(cfg)),
        "ln2": C.rmsnorm_specs(),
    }
    mcfg = _moe_cfg(cfg)
    if mcfg is not None:
        p["moe"] = moe_specs(mcfg)
    else:
        p["ffn"] = C.swiglu_specs()
    return p


def param_specs(cfg: ModelConfig) -> Params:
    check_supported(cfg)
    p: Params = {
        "embed": C.embedding_specs(),
        "layers": C.stacked_specs(_layer_specs(cfg)),
        "final_norm": C.rmsnorm_specs(),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = C.linear_specs(("embed", "vocab"))
    return p


def init(gen: torch.Generator, cfg: ModelConfig, device) -> ParamTree:
    check_supported(cfg)
    dt = _dt(cfg)
    p: Params = {
        "embed": C.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "layers": C.stack_params(
            gen, cfg.num_layers, lambda g: _init_layer(g, cfg, device)
        ),
        "final_norm": C.init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = C.init_linear(gen, cfg.d_model, cfg.vocab, dt, device)
    return ParamTree(p)


def _is_global_flags(cfg: ModelConfig) -> list:
    """Per-layer flag: True = full (global) attention."""
    L = cfg.num_layers
    if cfg.sliding_window is None or cfg.global_every is None:
        return [True] * L
    return [(i % cfg.global_every) == (cfg.global_every - 1) for i in range(L)]


# ---------------------------------------------------------------------------
# sharded runs: how a rank computes from its blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """What a rank of ``layout.mesh`` keeps split over the model axis."""
    layout: Layout
    tp: Optional[C.TP]   # None without a "model" axis of size > 1
    heads: bool          # attention heads split: wq / wo stay local
    kv: bool             # KV heads split too: wk / wv stay local
    mlp: bool            # the SwiGLU hidden dim split
    embed_vocab: bool    # the embedding table's vocab split
    head_vocab: bool     # the logits' vocab split
    dp: Tuple[str, ...]  # the batch axes of size > 1
    ep: Optional[EPGroup] = None  # MoE layers: expert-parallel, or dense over the global batch
    ssm: bool = False    # the recurrent mixers' heads split (hybrid's Mamba2, xLSTM's blocks)
    kv_seq: Tuple[str, ...] = ()  # decode: the axes that cut the cache by position
    seq: Tuple[str, ...] = ()     # train / prefill: the axes that cut the positions

    @property
    def kv_split(self) -> Optional[C.KVSplit]:
        """The decode cache's cut by position, if any."""
        return C.KVSplit(self.layout.mesh, self.kv_seq) if self.kv_seq else None

    @property
    def sp(self) -> Optional[C.TP]:
        """The axis that cuts the positions (sequence parallelism), if any:
        rank r of n holds positions [r S / n, (r + 1) S / n)."""
        return C.TP(self.layout.mesh, self.seq[0]) if self.seq else None

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Whole-vocab logits (no gradient)."""
        if not self.head_vocab:
            return logits
        return all_gather_axis(logits, self.tp.mesh, self.tp.axis, logits.dim() - 1)


def shard_plan(cfg: ModelConfig, layout: Layout) -> ShardPlan:
    check_supported(cfg)
    plan = tp_plan(cfg, layout, "layers.attn", None if cfg.moe is not None else "layers.ffn")
    if cfg.moe is None:
        return plan
    return dataclasses.replace(plan, ep=_ep_group(cfg, layout, plan.tp, plan.dp))


def seq_plan(plan, axes: Sequence[str]):
    """``plan`` with the positions cut over ``axes`` (``sharding.seq_axes``),
    as the reference's hints resolve under ``seq -> "model"``: ``seq``
    takes the model axis before ``heads``, ``mlp`` and ``vocab``, so every
    activation holds the rank's positions and no attention, MLP or vocab
    runs split; the weights are gathered whole (``_seq_weight``).  The
    blocks that gather the positions (``_SEQ_GATHERED``) keep their own
    parallelism: the recurrent mixers' heads split where the layout splits
    their weights (``plan.ssm``), the MoE layers' experts (``plan.ep``)."""
    if not axes:
        return plan
    return dataclasses.replace(plan, heads=False, kv=False, mlp=False, embed_vocab=False,
                               head_vocab=False, seq=tuple(axes))


def first_position(plan: Optional[ShardPlan], S: int) -> int:
    """The first of the S positions this rank holds (``C.first_position``
    of ``plan.sp``)."""
    return C.first_position(plan.sp if plan is not None else None, S)


def on_model(layout: Layout, key: str, dim: int) -> bool:
    """Whether dim ``dim`` of leaf ``key`` is split over a "model" axis of
    size > 1."""
    return layout.sizes.get("model", 1) > 1 and "model" in entry_axes(layout.specs[key][dim])


def tp_plan(cfg: ModelConfig, layout: Layout, attn: Optional[str], mlp: Optional[str],
            mlp_leaves: Tuple[str, ...] = ("wi", "wg"), mha: bool = False) -> ShardPlan:
    """The plan of a model whose attention leaves sit under ``attn``
    (``wq`` ... ``wo``) and whose MLP sits under ``mlp`` (``mlp_leaves``
    column-parallel, ``wo`` row-parallel), from their specs' last two dims,
    so stacked and unstacked leaves alike.  ``mha``: split the heads only
    with the KV heads (a caller that attends through ``common.attention``
    needs whole KV groups on a rank)."""
    tp = C.TP(layout.mesh) if layout.sizes.get("model", 1) > 1 else None

    def split(key: str, dim: int) -> bool:
        return on_model(layout, key, dim)

    heads = (attn is not None and split(f"{attn}.wq.w", -1) and split(f"{attn}.wo.w", -2)
             and cfg.heads % tp.size == 0)
    kv = (heads and split(f"{attn}.wk.w", -1) and split(f"{attn}.wv.w", -1)
          and cfg.kv_heads % tp.size == 0)
    if mha:
        heads = kv
    mlp_split = mlp is not None and split(f"{mlp}.wo.w", -2) and all(
        split(f"{mlp}.{k}.w", -1) for k in mlp_leaves)
    embed_vocab = split("embed.table", 0)
    head_vocab = embed_vocab if cfg.tie_embeddings else split("lm_head.w", 1)
    dp = tuple(a for a in dp_axes(layout.sizes) if layout.sizes[a] > 1)
    return ShardPlan(layout, tp, heads, kv, mlp_split, embed_vocab, head_vocab, dp)


def _ep_group(cfg: ModelConfig, layout: Layout, tp: Optional[C.TP],
              dp: Tuple[str, ...]) -> EPGroup:
    """The MoE layers' parallelism on ``layout``, as the reference's
    ``moe_ffn``: expert-parallel over ``cfg.moe_ep_axis`` when the mesh has
    it (the experts split over it, their F dim over "model" with
    ``moe_tp`` unless "model" is the EP axis, the tokens over ("pod", EP
    axis)); else dense over the global batch (``moe.moe_ffn_global``), the
    F dim split over "model" when the layout splits it."""
    axis, sizes = cfg.moe_ep_axis, layout.sizes
    E, F = cfg.moe.num_experts, cfg.moe.d_ff
    if axis not in sizes:
        f_split = tp is not None and on_model(layout, "layers.moe.wi", 3)
        return EPGroup(layout.mesh, dp, tp if f_split else None, axis=None)
    if E % sizes[axis]:
        raise ValueError(f"{cfg.name}: {E} experts do not split over {axis!r} "
                         f"({sizes[axis]}); the reference's moe_ffn_ep asserts E % ep == 0")
    moe_tp = tp if cfg.moe_tp and tp is not None and tp.axis != axis else None
    if moe_tp is not None and F % moe_tp.size:
        raise ValueError(f"{cfg.name}: d_ff {F} does not split over 'model' ({moe_tp.size}), "
                         "which the reference's moe_ffn_ep needs")
    batch = tuple(dict.fromkeys(a for a in ("pod", axis) if sizes.get(a, 1) > 1))
    return EPGroup(layout.mesh, batch, moe_tp, axis=axis, rows=dp)


def _weight(w: torch.Tensor, spec, plan: ShardPlan, keep_model: bool, partial: bool):
    """The weight a rank computes with: its block all-gathered over every
    axis of ``spec`` (FSDP: the gradient reduce-scattered), except the
    model axis when ``keep_model``; a model gather is ``partial`` (the
    gathered weight feeds this rank's share of a split block) or whole."""
    mesh = plan.layout.mesh
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            if plan.tp is not None and a == plan.tp.axis:
                if not keep_model:
                    w = (gather if partial else gather_whole)(w, mesh, a, dim)
            else:
                w = gather(w, mesh, a, dim)
    return w


def _seq_weight(w: torch.Tensor, spec, plan: ShardPlan) -> torch.Tensor:
    """A weight under sequence parallelism: whole on every rank, its
    gradient (this rank's positions' share) summed over the seq axis: the
    model blocks gathered with their gradient reduce-scattered, a leaf whole
    over that axis through ``copy_to``."""
    w = _weight(w, spec, plan, False, True)
    axis = plan.sp.axis
    if not any(axis in entry_axes(e) for e in spec):
        w = copy_to(w, plan.layout.mesh, axis)
    return w


_EXPERT_LEAVES = ("layers.moe.wi", "layers.moe.wg", "layers.moe.wo")


def _expert_weight(w: torch.Tensor, spec, plan: ShardPlan, f_dim: int) -> torch.Tensor:
    """An expert leaf as the MoE layer takes it: its experts (dim 0) split
    over the EP axis and its F dim (``f_dim``) over ``plan.ep.tp``, whole
    otherwise, regrouped from the stored blocks (``spec``) as the
    reference's ``shard_map`` reshards them."""
    ep, sizes = plan.ep, plan.layout.sizes
    moves = []
    for dim, entry in enumerate(spec):
        src = tuple(a for a in entry_axes(entry) if sizes[a] > 1)
        dst = ()
        if dim == 0 and ep.axis is not None and sizes[ep.axis] > 1:
            dst = (ep.axis,)
        elif dim == f_dim and ep.tp is not None:
            dst = (ep.tp.axis,)
        moves.append((dim, src, dst))
    return regroup(w, plan.layout.mesh, moves)


_ATTN_BLOCKS = ("attn", "self_attn", "cross_attn")
_MLP_BLOCKS = ("ffn", "mlp")
# the blocks that gather the positions under sequence parallelism and run
# as without the cut (``common.seq_gather``)
_SEQ_GATHERED = ("moe", "mix", "mlstm", "slstm")


def _layer_weights(lp, plan: ShardPlan, prefix: str = "layers.", lead: int = 1,
                   split: Optional[Dict[str, bool]] = None, keep=None):
    """``_weight`` over every leaf of a layer slice (``lead`` stacked dims
    dropped from the specs).  A leaf of a block that runs split over the
    model axis (``split``: block name -> bool; by default attention with
    ``plan.heads``, the MLP with ``plan.mlp``) keeps its model block when
    ``keep(key)`` (default ``_keeps_model``); otherwise it is gathered
    ``partial`` or, when whole, passes ``copy_to``: its gradient is summed
    over the model axis.  The MoE expert leaves keep their blocks
    (``_expert_weight``).  Under sequence parallelism every leaf outside
    the ``_SEQ_GATHERED`` blocks is ``_seq_weight``'s; those blocks' leaves
    are as without the cut."""
    if split is None:
        split = {**{b: plan.heads for b in _ATTN_BLOCKS}, **{b: plan.mlp for b in _MLP_BLOCKS}}
    keep = keep or (lambda key: _keeps_model(plan, key))
    out = {}
    for k in lp.keys():
        v, key = lp[k], f"{prefix}{k}"
        if not torch.is_tensor(v):
            out[k] = _layer_weights(v, plan, key + ".", lead, split, keep)
            continue
        spec = plan.layout.specs[key][lead:]  # the stacked dims are gone
        block = key.split(".")[1]
        if plan.seq and block not in _SEQ_GATHERED:
            out[k] = _seq_weight(v, spec, plan)
            continue
        if key in _EXPERT_LEAVES:
            out[k] = _expert_weight(v, spec, plan, 1 if k == "wo" else 2)
            continue
        in_split = split.get(block, False)
        kept = in_split and keep(key)
        w = _weight(v, spec, plan, kept, in_split)
        if in_split and not kept and not any(plan.tp.axis in entry_axes(e) for e in spec):
            w = copy_to(w, plan.tp.mesh, plan.tp.axis)
        out[k] = w
    return out


def _keeps_model(plan: ShardPlan, key: str) -> bool:
    block, leaf = key.split(".")[-3], key.split(".")[-2]
    if block in _ATTN_BLOCKS:
        return plan.heads if leaf in ("wq", "wo") else plan.kv and leaf in ("wk", "wv")
    return block in _MLP_BLOCKS and plan.mlp


def _local_attn(acfg: C.AttnConfig, plan: Optional[ShardPlan]) -> C.AttnConfig:
    """The head counts of the projections a rank computes."""
    if plan is None or not plan.heads:
        return acfg
    tp = plan.tp.size
    return dataclasses.replace(acfg, heads=acfg.heads // tp,
                               kv_heads=acfg.kv_heads // tp if plan.kv else acfg.kv_heads)


def _kv_for_heads(k, v, acfg: C.AttnConfig, plan: Optional[ShardPlan]):
    """The KV heads that this rank's query heads attend with, from whole
    KV heads (the heads split, the KV heads not)."""
    if plan is None or not plan.heads or plan.kv:
        return k, v
    hl = acfg.heads // plan.tp.size
    first = plan.tp.rank * hl
    g = acfg.heads // acfg.kv_heads
    if hl % g == 0 or g % hl == 0:
        n = max(hl // g, 1)
        return k.narrow(2, first // g, n), v.narrow(2, first // g, n)
    idx = torch.arange(first, first + hl, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _outer(params, key: str, plan: Optional[ShardPlan], keep_model: bool) -> torch.Tensor:
    """A leaf outside the layers: as stored, or as a rank computes with it."""
    node = params
    for k in key.split("."):
        node = node[k]
    if plan is None:
        return node
    if plan.seq:
        return _seq_weight(node, plan.layout.specs[key], plan)
    return _weight(node, plan.layout.specs[key], plan, keep_model, False)


def embed_tokens(params, ids, dt: DTypes, plan: Optional[ShardPlan] = None) -> torch.Tensor:
    """Rows of ``embed.table``; vocab-parallel with ``plan.embed_vocab``;
    under sequence parallelism the rank's positions' rows from the table's
    vocab blocks (``common.seq_vocab_embed``) where the layout splits its
    vocab over the seq axis."""
    if plan is not None and plan.seq and on_model(plan.layout, "embed.table", 0):
        block = _weight(params["embed"]["table"], plan.layout.specs["embed.table"], plan, True,
                        False)
        return C.seq_vocab_embed({"table": block}, ids, dt, plan.sp)
    vocab = plan is not None and plan.embed_vocab
    table = {"table": _outer(params, "embed.table", plan, vocab)}
    if vocab:
        return C.vocab_embed(table, ids, dt, plan.tp)
    return C.embed(table, ids, dt)


def _seq_logits(params, key: str, x, dt: DTypes, plan: ShardPlan) -> torch.Tensor:
    """Under sequence parallelism: the logits of the rank's positions over
    the whole vocab, from ``key`` (``embed.table``, tied, or ``lm_head.w``)
    gathered whole inside a checkpoint, so that the whole weight lives only
    while the logits and their gradients are formed (gathered again in the
    backward), never across the loss between them."""
    node = params
    for k in key.split("."):
        node = node[k]
    spec = plan.layout.specs[key]

    def logits(w, x):
        w = _seq_weight(w, spec, plan)
        return C.unembed({"table": w}, x, dt) if key == "embed.table" else C.linear({"w": w}, x, dt)

    if torch.is_grad_enabled():
        return checkpoint(logits, node, x, use_reentrant=False)
    return logits(node, x)


def tied_logits(params, x, dt: DTypes, plan: Optional[ShardPlan] = None) -> torch.Tensor:
    """x @ embed.tableᵀ; with ``plan.head_vocab`` this rank's vocab slice."""
    if plan is not None and plan.seq:
        return _seq_logits(params, "embed.table", x, dt, plan)
    split = plan is not None and plan.head_vocab
    table = {"table": _outer(params, "embed.table", plan, split)}
    return C.vocab_unembed(table, x, dt, plan.tp) if split else C.unembed(table, x, dt)


def _embed(params, cfg: ModelConfig, batch, dt: DTypes,
           plan: Optional[ShardPlan] = None) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"].to(cfg.compute_dtype)
    x = embed_tokens(params, batch["tokens"], dt, plan)
    # sqrt(d_model) rounded to the compute dtype first, as the reference
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype, device=x.device)


def _unembed(params, cfg: ModelConfig, x, dt: DTypes,
             plan: Optional[ShardPlan] = None) -> torch.Tensor:
    """Logits; with ``plan.head_vocab`` this rank's vocab slice only."""
    x = C.rmsnorm({"scale": _outer(params, "final_norm.scale", plan, False)}, x)
    if cfg.tie_embeddings:
        return tied_logits(params, x, dt, plan)
    if plan is not None and plan.seq:
        return _seq_logits(params, "lm_head.w", x, dt, plan)
    split = plan is not None and plan.head_vocab
    head = {"w": _outer(params, "lm_head.w", plan, split)}
    return C.column_linear(head, x, dt, plan.tp) if split else C.linear(head, x, dt)


def _qkv(p, acfg: C.AttnConfig, x, positions, positions3, dt):
    """q, k, v with rope: M-RoPE at ``positions3`` (3, B, S) when the config
    has sections and they are given, else 1-D rope at ``positions``."""
    B, S, _ = x.shape
    H, Hk, Dh = acfg.heads, acfg.kv_heads, acfg.head_dim
    q = C.linear(p["wq"], x, dt).reshape(B, S, H, Dh)
    k = C.linear(p["wk"], x, dt).reshape(B, S, Hk, Dh)
    v = C.linear(p["wv"], x, dt).reshape(B, S, Hk, Dh)
    if acfg.qk_norm:
        q = C.rmsnorm(p["q_norm"], q)
        k = C.rmsnorm(p["k_norm"], k)
    if acfg.mrope_sections is not None and positions3 is not None:
        q = C.apply_mrope(q, positions3, acfg.mrope_sections, acfg.rope_theta)
        k = C.apply_mrope(k, positions3, acfg.mrope_sections, acfg.rope_theta)
    else:
        q = C.apply_rope(q, positions, acfg.rope_theta)
        k = C.apply_rope(k, positions, acfg.rope_theta)
    return q, k, v


def _attn_out(p, out, dt, plan: Optional[ShardPlan]):
    """wo: row-parallel when the heads are split."""
    if plan is not None and plan.heads:
        return C.row_linear(p["wo"], out, dt, plan.tp)
    return C.linear(p["wo"], out, dt)


def _attention_dynwin(p, acfg: C.AttnConfig, x, positions, positions3, is_global: bool, dt,
                      impl: str, plan: Optional[ShardPlan] = None):
    """Attention with the sliding window switched per layer: a local layer
    keeps keys with kpos > qpos - window, a global one all of them.
    ``"flash"`` takes the CUDA kernels, forward and backward, on the rank's
    heads, with the layer's window or none; ``"ref"`` is the plain path.
    (The reference reaches its flash path only without a window; both
    compute the same function.)  Under sequence parallelism x holds the
    rank's positions: K and V are gathered over the seq axis (their
    gradients reduce-scattered) and the rank's queries attend from offset
    ``rank * S``."""
    B, S, _ = x.shape
    local = _local_attn(acfg, plan)
    H, Dh = local.heads, acfg.head_dim
    if plan is not None and plan.heads:
        x = copy_to(x, plan.tp.mesh, plan.tp.axis)
    q, k, v = _qkv(p, local, x, positions, positions3, dt)
    k, v = _kv_for_heads(k, v, acfg, plan)
    sp = plan.sp if plan is not None else None
    k, v = C.seq_gather_kv(k, v, sp)
    offset = C.first_position(sp, S)
    window = None if is_global else acfg.window
    if impl == "flash":
        out = flash_attention(q, k, v, causal=acfg.causal, window=window,
                              scale=1.0 / math.sqrt(Dh), q_offset=offset)
        return _attn_out(p, out.reshape(B, S, H * Dh), dt, plan)
    qpos = torch.arange(S, device=x.device)[:, None] + offset
    kpos = torch.arange(k.shape[1], device=x.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    out = C.masked_attention(q, k, v, mask, 1.0 / math.sqrt(Dh))
    return _attn_out(p, out.reshape(B, S, H * Dh), dt, plan)


def _ffn(lp, cfg: ModelConfig, h, dt, plan: Optional[ShardPlan], tracer=None):
    """The MLP or MoE block: (output, aux loss or None).  Under sequence
    parallelism the MoE layer routes the tokens of the uncut rows, in
    their order (rows, then positions), so its capacity and its kept and
    dropped assignments are those without the cut; every rank of the seq
    axis computes the same aux, whose gradient is not summed over it.
    ``tracer`` goes to ``moe_ffn``."""
    if "moe" not in lp:
        return C.swiglu(lp["ffn"], h, dt, plan.tp if plan is not None and plan.mlp else None), None
    sp = plan.sp if plan is not None else None
    if sp is not None:
        h = C.seq_gather(h, sp, False)
    out, aux = moe_ffn(lp["moe"], _moe_cfg(cfg), h, dt, plan.ep if plan is not None else None,
                       tracer)
    return (C.seq_scatter(out, sp, False) if sp is not None else out), aux


def _layer_fwd(lp, cfg: ModelConfig, x, positions, positions3, is_global: bool, dt: DTypes,
               plan: Optional[ShardPlan] = None, tracer=None):
    if plan is not None:
        lp = _layer_weights(lp, plan)
    h = C.rmsnorm(lp["ln1"], x)
    x = x + _attention_dynwin(lp["attn"], _attn_cfg(cfg), h, positions, positions3, is_global,
                              dt, cfg.attn_impl, plan)
    h = C.rmsnorm(lp["ln2"], x)
    out, aux = _ffn(lp, cfg, h, dt, plan, tracer)
    return x + out, aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            plan: Optional[ShardPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) int [or embeds (B, S, D)], positions (B, S)
    optional, positions3 (3, B, S) for M-RoPE.  Returns (logits, aux): aux
    is the MoE layers' aux loss summed over the layers (under EP, its mean
    over the batch axes), 0 for the dense family.  With ``plan.seq`` every
    entry holds the rank's block of positions (``sharding.rank_batch``)
    and so do the logits."""
    check_supported(cfg)
    dt = _dt(cfg)
    x = _embed(params, cfg, batch, dt, plan)
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = (first_position(plan, S) + torch.arange(S, device=x.device))[None].expand(B, S)
    positions3 = batch.get("positions3")
    remat = cfg.remat and torch.is_grad_enabled()
    layers = C.layer_slices(params["layers"], cfg.num_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # one tracer for the forward and remat's recompute (moe_ffn's span nodes)
    trc = get_tracer()
    for lp, is_global in zip(layers, _is_global_flags(cfg)):
        if remat:
            x, aux_l = checkpoint(_layer_fwd, lp, cfg, x, positions, positions3, is_global, dt,
                                  plan, trc, use_reentrant=False)
        else:
            x, aux_l = _layer_fwd(lp, cfg, x, positions, positions3, is_global, dt, plan, trc)
        if aux_l is not None:
            aux = aux + aux_l
    if plan is not None and plan.ep is not None:
        aux = aux_mean(aux, plan.ep)  # once for all layers, where the reference pmeans each
    return _unembed(params, cfg, x, dt, plan), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> Dict[str, Any]:
    L, Hk, Dh = cfg.num_layers, cfg.kv_heads, cfg.resolved_head_dim
    shape = (L, batch, cache_len, Hk, Dh)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "index": 0,
    }


def cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "k": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
        "index": (),
    }


def _decode_attention(p, acfg: C.AttnConfig, x, positions, positions3, is_global: bool, ck, cv,
                      index: int, dt, plan: Optional[ShardPlan] = None):
    """Attention of S new tokens over the cache of one layer; ck/cv
    (B, cache_len, Hk, Dh), this rank's rows, KV heads and positions
    (``plan.kv_seq``), are written in place at ``index``."""
    B, S, _ = x.shape
    local = _local_attn(acfg, plan)
    H, Dh = local.heads, acfg.head_dim
    if plan is not None and plan.heads:
        x = copy_to(x, plan.tp.mesh, plan.tp.axis)
    q, k, v = _qkv(p, local, x, positions, positions3, dt)
    if ck.shape[0] != B or ck.shape[2] != k.shape[2]:
        raise ValueError(f"a cache of {ck.shape[0]} rows and {ck.shape[2]} KV heads for "
                         f"{B} rows and {k.shape[2]} KV heads: the cache is sharded unlike "
                         "the step")
    split = plan.kv_split if plan is not None else None
    # dynamic_update_slice clamps the start so the update fits; the mask
    # still uses the unclamped index (a reference quirk, kept)
    C.cache_write(ck, cv, k, v, index, split)
    ck, cv = _kv_for_heads(ck, cv, acfg, plan)
    window = acfg.window if not is_global else None
    out = C.cache_attend(q, ck, cv, index, 1.0 / math.sqrt(Dh), window, split)
    return _attn_out(p, out.reshape(B, S, H * Dh), dt, plan)


def decode_step(
    params, cfg: ModelConfig, cache: Dict[str, Any], batch: Dict[str, torch.Tensor],
    plan: Optional[ShardPlan] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """S new tokens: batch has tokens (B, S) [or embeds (B, S, D)] and, for
    M-RoPE, optionally positions3 (3, B, S).  Writes the cache in place and
    returns it with ``index`` advanced by S."""
    check_supported(cfg)
    dt = _dt(cfg)
    x = _embed(params, cfg, batch, dt, plan)
    B, S, _ = x.shape
    index = cache["index"]
    split = plan.kv_split if plan is not None else None
    cache_len = cache["k"].shape[2] * (split.size if split is not None else 1)
    if S > cache_len:
        raise ValueError(f"{S} tokens do not fit a cache of length {cache_len}")
    positions = (index + torch.arange(S, device=x.device))[None].expand(B, S)
    positions3 = batch.get("positions3")
    acfg = _attn_cfg(cfg)
    for i, is_global in enumerate(_is_global_flags(cfg)):
        lp = C.layer_slice(params["layers"], i)
        if plan is not None:
            lp = _layer_weights(lp, plan)
        h = C.rmsnorm(lp["ln1"], x)
        x = x + _decode_attention(
            lp["attn"], acfg, h, positions, positions3, is_global, cache["k"][i], cache["v"][i],
            index, dt, plan)
        h = C.rmsnorm(lp["ln2"], x)
        x = x + _ffn(lp, cfg, h, dt, plan)[0]  # the reference drops aux in decode
    logits = _unembed(params, cfg, x, dt, plan)
    return logits, {"k": cache["k"], "v": cache["v"], "index": index + S}
