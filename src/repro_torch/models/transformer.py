"""Decoder-only transformer LM, dense and MoE families (counterpart of
``repro/models/transformer.py``).

Covers qwen3-8b (qk-norm, untied lm_head), llama3.2-3b and granite-20b
(MQA), and, with a ``"moe"`` block in place of the ``"ffn"`` one,
moonshot-v1-16b-a3b, qwen3-moe-235b-a22b and paper-llama3-moe
(``models/moe.py``).  Layers are stacked with a leading ``L`` dim, as in
the reference; a Python loop over that dim takes the place of
``lax.scan``.  With ``cfg.remat`` and gradients on, each layer runs under
``torch.utils.checkpoint`` (non-reentrant): nothing inside a layer is kept
for the backward, which recomputes it, as ``jax.checkpoint`` with
``nothing_saveable`` does in the reference.  Each layer returns its MoE
aux loss, summed over the layers as the reference's scan carry does (0
for the dense family).  M-RoPE configs raise: they come with a later
slice.

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
runs expert-parallel (``moe.moe_ffn_ep``): its expert leaves keep their
"data" block (E/|data| experts a rank, never gathered) and, with TP, their
"model" block (F/|model| columns); the tokens go to their experts by an
all-to-all over "data".  The router passes whole.  The layers' aux sum is
averaged over the batch axes once (``moe.aux_mean``).  Batch rows are
the caller's: the step passes each rank its rows, and the cache its rows
and KV heads.

The cache is ``{"k", "v": (L, B, cache_len, Hk, Dh), "index": int}``.
``index`` is a host int (the reference keeps a device scalar) so a decode
step needs no device sync.  ``decode_step`` writes the cache in place: the
reference donates its cache to the jitted step, and this is the
counterpart, so the cache passed in must not be used again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..collectives.autograd import copy_to, gather, gather_whole
from ..collectives.schedules import all_gather_axis
from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
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
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE comes with the vlm slice")
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
    ep: Optional[EPGroup] = None  # MoE layers: expert-parallel over "data"

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Whole-vocab logits (no gradient)."""
        if not self.head_vocab:
            return logits
        return all_gather_axis(logits, self.tp.mesh, self.tp.axis, logits.dim() - 1)


def shard_plan(cfg: ModelConfig, layout: Layout) -> ShardPlan:
    check_supported(cfg)
    tp = C.TP(layout.mesh) if layout.sizes.get("model", 1) > 1 else None

    def on_model(key: str, dim: int) -> bool:
        return tp is not None and tp.axis in entry_axes(layout.specs[key][dim])

    heads = (on_model("layers.attn.wq.w", 2) and on_model("layers.attn.wo.w", 1)
             and cfg.heads % tp.size == 0)
    kv = (heads and on_model("layers.attn.wk.w", 2) and on_model("layers.attn.wv.w", 2)
          and cfg.kv_heads % tp.size == 0)
    mlp = cfg.moe is None and (on_model("layers.ffn.wi.w", 2) and on_model("layers.ffn.wg.w", 2)
                               and on_model("layers.ffn.wo.w", 1))
    embed_vocab = on_model("embed.table", 0)
    head_vocab = embed_vocab if cfg.tie_embeddings else on_model("lm_head.w", 1)
    dp = tuple(a for a in dp_axes(layout.sizes) if layout.sizes[a] > 1)
    ep = _ep_group(cfg, layout, tp, dp) if cfg.moe is not None else None
    return ShardPlan(layout, tp, heads, kv, mlp, embed_vocab, head_vocab, dp, ep)


def _ep_group(cfg: ModelConfig, layout: Layout, tp: Optional[C.TP],
              dp: Tuple[str, ...]) -> EPGroup:
    """The MoE layers' expert parallelism on ``layout``: the experts split
    over the EP axis ("data"), and their F dim over "model" when the config
    splits it (``moe_tp``), as the reference's ``moe_ffn_ep`` takes them."""
    axis = cfg.moe_ep_axis
    if axis != "data" or axis not in layout.sizes:
        raise NotImplementedError(
            f"{cfg.name}: the MoE layers run expert-parallel over the mesh's 'data' axis; "
            f"mesh axes {tuple(layout.sizes)}, EP axis {axis!r}")
    moe_tp = tp if cfg.moe_tp else None
    for key, f_dim in (("layers.moe.wi", 3), ("layers.moe.wg", 3), ("layers.moe.wo", 2)):
        spec = layout.specs[key]
        if axis not in entry_axes(spec[1]):
            raise ValueError(f"{key} {spec}: {cfg.moe.num_experts} experts do not split over "
                             f"{axis!r} ({layout.sizes[axis]}); the reference's moe_ffn_ep "
                             "asserts E % ep == 0")
        if moe_tp is not None and moe_tp.axis not in entry_axes(spec[f_dim]):
            raise ValueError(f"{key} {spec}: d_ff {cfg.moe.d_ff} does not split over "
                             f"'model' ({moe_tp.size}), which the reference's moe_ffn_ep needs")
    return EPGroup(layout.mesh, dp, moe_tp)


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


_EXPERT_LEAVES = ("layers.moe.wi", "layers.moe.wg", "layers.moe.wo")


def _expert_weight(w: torch.Tensor, spec, plan: ShardPlan) -> torch.Tensor:
    """An expert leaf as ``moe_ffn_ep`` takes it: the rank's block over
    "data" (EP), and over "model" when the experts run F-split; gathered
    whole over "model" when they do not."""
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            if a == "model" and plan.ep.tp is None:
                w = gather_whole(w, plan.layout.mesh, a, dim)
    return w


def _layer_weights(lp, plan: ShardPlan, prefix: str = "layers."):
    """``_weight`` over every leaf of a layer slice.  A leaf of a block that
    runs split over the model axis (attention with ``plan.heads``, the MLP
    with ``plan.mlp``) but is not split itself is gathered ``partial`` or,
    when whole, passes ``copy_to``: its gradient is summed over the model
    axis.  The MoE expert leaves keep their blocks (``_expert_weight``)."""
    out = {}
    for k in lp.keys():
        v, key = lp[k], f"{prefix}{k}"
        if not torch.is_tensor(v):
            out[k] = _layer_weights(v, plan, key + ".")
            continue
        spec = plan.layout.specs[key][1:]  # the layer dim is gone
        if key in _EXPERT_LEAVES:
            out[k] = _expert_weight(v, spec, plan)
            continue
        block = key.split(".")[1]
        in_split = {"attn": plan.heads, "ffn": plan.mlp}.get(block, False)
        keep = in_split and _keeps_model(plan, key)
        w = _weight(v, spec, plan, keep, in_split)
        if in_split and not keep and not any(plan.tp.axis in entry_axes(e) for e in spec):
            w = copy_to(w, plan.tp.mesh, plan.tp.axis)
        out[k] = w
    return out


def _keeps_model(plan: ShardPlan, key: str) -> bool:
    if ".wq." in key or ".attn.wo." in key:
        return plan.heads
    if ".wk." in key or ".wv." in key:
        return plan.kv
    if ".ffn." in key:
        return plan.mlp
    return False


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
    return _weight(node, plan.layout.specs[key], plan, keep_model, False)


def _embed(params, cfg: ModelConfig, batch, dt: DTypes,
           plan: Optional[ShardPlan] = None) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"].to(cfg.compute_dtype)
    vocab = plan is not None and plan.embed_vocab
    table = {"table": _outer(params, "embed.table", plan, vocab)}
    if vocab:
        x = C.vocab_embed(table, batch["tokens"], dt, plan.tp)
    else:
        x = C.embed(table, batch["tokens"], dt)
    # sqrt(d_model) rounded to the compute dtype first, as the reference
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype, device=x.device)


def _unembed(params, cfg: ModelConfig, x, dt: DTypes,
             plan: Optional[ShardPlan] = None) -> torch.Tensor:
    """Logits; with ``plan.head_vocab`` this rank's vocab slice only."""
    x = C.rmsnorm({"scale": _outer(params, "final_norm.scale", plan, False)}, x)
    split = plan is not None and plan.head_vocab
    if cfg.tie_embeddings:
        table = {"table": _outer(params, "embed.table", plan, split)}
        return C.vocab_unembed(table, x, dt, plan.tp) if split else C.unembed(table, x, dt)
    head = {"w": _outer(params, "lm_head.w", plan, split)}
    return C.column_linear(head, x, dt, plan.tp) if split else C.linear(head, x, dt)


def _qkv(p, acfg: C.AttnConfig, x, positions, dt):
    B, S, _ = x.shape
    H, Hk, Dh = acfg.heads, acfg.kv_heads, acfg.head_dim
    q = C.linear(p["wq"], x, dt).reshape(B, S, H, Dh)
    k = C.linear(p["wk"], x, dt).reshape(B, S, Hk, Dh)
    v = C.linear(p["wv"], x, dt).reshape(B, S, Hk, Dh)
    if acfg.qk_norm:
        q = C.rmsnorm(p["q_norm"], q)
        k = C.rmsnorm(p["k_norm"], k)
    q = C.apply_rope(q, positions, acfg.rope_theta)
    k = C.apply_rope(k, positions, acfg.rope_theta)
    return q, k, v


def _attn_out(p, out, dt, plan: Optional[ShardPlan]):
    """wo: row-parallel when the heads are split."""
    if plan is not None and plan.heads:
        return C.row_linear(p["wo"], out, dt, plan.tp)
    return C.linear(p["wo"], out, dt)


def _attention_dynwin(p, acfg: C.AttnConfig, x, positions, is_global: bool, dt, impl: str,
                      plan: Optional[ShardPlan] = None):
    """Attention with the sliding window switched per layer.  ``"flash"``
    without a window takes the CUDA kernels, forward and backward, on the
    rank's heads; everything else is the plain path."""
    B, S, _ = x.shape
    local = _local_attn(acfg, plan)
    H, Dh = local.heads, acfg.head_dim
    if plan is not None and plan.heads:
        x = copy_to(x, plan.tp.mesh, plan.tp.axis)
    q, k, v = _qkv(p, local, x, positions, dt)
    k, v = _kv_for_heads(k, v, acfg, plan)
    if impl == "flash" and acfg.window is None:
        out = flash_attention(q, k, v, causal=acfg.causal, scale=1.0 / math.sqrt(Dh))
        return _attn_out(p, out.reshape(B, S, H * Dh), dt, plan)
    qpos = torch.arange(S, device=x.device)[:, None]
    kpos = torch.arange(S, device=x.device)[None, :]
    mask = kpos <= qpos
    if acfg.window is not None and not is_global:
        mask = mask & (kpos > qpos - acfg.window)
    out = C.masked_attention(q, k, v, mask, 1.0 / math.sqrt(Dh))
    return _attn_out(p, out.reshape(B, S, H * Dh), dt, plan)


def _ffn(lp, cfg: ModelConfig, h, dt, plan: Optional[ShardPlan]):
    """The MLP or MoE block: (output, aux loss or None)."""
    if "moe" in lp:
        return moe_ffn(lp["moe"], _moe_cfg(cfg), h, dt, plan.ep if plan is not None else None)
    return C.swiglu(lp["ffn"], h, dt, plan.tp if plan is not None and plan.mlp else None), None


def _layer_fwd(lp, cfg: ModelConfig, x, positions, is_global: bool, dt: DTypes,
               plan: Optional[ShardPlan] = None):
    if plan is not None:
        lp = _layer_weights(lp, plan)
    h = C.rmsnorm(lp["ln1"], x)
    x = x + _attention_dynwin(lp["attn"], _attn_cfg(cfg), h, positions, is_global, dt,
                              cfg.attn_impl, plan)
    h = C.rmsnorm(lp["ln2"], x)
    out, aux = _ffn(lp, cfg, h, dt, plan)
    return x + out, aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            plan: Optional[ShardPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) int [or embeds (B, S, D)], positions (B, S)
    optional.  Returns (logits, aux): aux is the MoE layers' aux loss summed
    over the layers (under EP, its mean over the batch axes), 0 for the
    dense family."""
    check_supported(cfg)
    dt = _dt(cfg)
    x = _embed(params, cfg, batch, dt, plan)
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    layers = C.layer_slices(params["layers"], cfg.num_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, is_global in zip(layers, _is_global_flags(cfg)):
        if remat:
            x, aux_l = checkpoint(_layer_fwd, lp, cfg, x, positions, is_global, dt, plan,
                                  use_reentrant=False)
        else:
            x, aux_l = _layer_fwd(lp, cfg, x, positions, is_global, dt, plan)
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


def _decode_attention(p, acfg: C.AttnConfig, x, positions, is_global: bool, ck, cv, index: int,
                      dt, plan: Optional[ShardPlan] = None):
    """Attention of S new tokens over the cache of one layer; ck/cv
    (B, cache_len, Hk, Dh), this rank's rows and KV heads, are written in
    place at ``index``."""
    B, S, _ = x.shape
    local = _local_attn(acfg, plan)
    H, Dh = local.heads, acfg.head_dim
    if plan is not None and plan.heads:
        x = copy_to(x, plan.tp.mesh, plan.tp.axis)
    q, k, v = _qkv(p, local, x, positions, dt)
    if ck.shape[0] != B or ck.shape[2] != k.shape[2]:
        raise ValueError(f"a cache of {ck.shape[0]} rows and {ck.shape[2]} KV heads for "
                         f"{B} rows and {k.shape[2]} KV heads: the cache is sharded unlike "
                         "the step")
    Skv = ck.shape[1]
    # dynamic_update_slice clamps the start so the update fits; the mask
    # below still uses the unclamped index (a reference quirk, kept)
    start = min(max(index, 0), Skv - S)
    ck[:, start:start + S] = k.to(ck.dtype)
    cv[:, start:start + S] = v.to(cv.dtype)
    qpos = torch.arange(S, device=x.device)[:, None] + index
    kpos = torch.arange(Skv, device=x.device)[None, :]
    mask = kpos <= qpos
    if acfg.window is not None and not is_global:
        mask = mask & (kpos > qpos - acfg.window)
    ck, cv = _kv_for_heads(ck, cv, acfg, plan)
    out = C.masked_attention(q, ck, cv, mask, 1.0 / math.sqrt(Dh))
    return _attn_out(p, out.reshape(B, S, H * Dh), dt, plan)


def decode_step(
    params, cfg: ModelConfig, cache: Dict[str, Any], batch: Dict[str, torch.Tensor],
    plan: Optional[ShardPlan] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """S new tokens: batch has tokens (B, S) [or embeds (B, S, D)].  Writes
    the cache in place and returns it with ``index`` advanced by S."""
    check_supported(cfg)
    dt = _dt(cfg)
    x = _embed(params, cfg, batch, dt, plan)
    B, S, _ = x.shape
    index = cache["index"]
    if S > cache["k"].shape[2]:
        raise ValueError(f"{S} tokens do not fit a cache of length {cache['k'].shape[2]}")
    positions = (index + torch.arange(S, device=x.device))[None].expand(B, S)
    acfg = _attn_cfg(cfg)
    for i, is_global in enumerate(_is_global_flags(cfg)):
        lp = C.layer_slice(params["layers"], i)
        if plan is not None:
            lp = _layer_weights(lp, plan)
        h = C.rmsnorm(lp["ln1"], x)
        x = x + _decode_attention(
            lp["attn"], acfg, h, positions, is_global, cache["k"][i], cache["v"][i], index, dt,
            plan)
        h = C.rmsnorm(lp["ln2"], x)
        x = x + _ffn(lp, cfg, h, dt, plan)[0]  # the reference drops aux in decode
    logits = _unembed(params, cfg, x, dt, plan)
    return logits, {"k": cache["k"], "v": cache["v"], "index": index + S}
