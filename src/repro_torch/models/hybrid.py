"""Zamba2-style hybrid: Mamba2 backbone plus one *shared* attention block
(counterpart of ``repro/models/hybrid.py``, [arXiv:2411.15242]).

zamba2-7b: 81 Mamba2 layers; after every 6th one the shared transformer
block (attention + SwiGLU) runs on concat(hidden, initial embedding) through
a down-projection.  Its weights are shared by its 13 calls; each call has
its own KV cache.  Params and caches stack the grouped layers with two
leading dims ``(groups, g, ...)`` and the ``num_layers % g`` tail layers with
one, as in the reference; without a tail the tree has no ``tail`` entry (the
reference's is ``{}``, which flattens to nothing).  Python loops over those
dims take the place of the nested ``lax.scan``s.

The embedding has no sqrt(d_model) factor (the reference calls ``C.embed``
directly).  The shared block's attention is the plain path
(``common.attention``; head dim 112 at zamba2-7b), as the reference's calls
``C.attention`` without ``impl``; Mamba2's full-sequence scan runs the SSD
kernel on the card.

API as the dense family (``models/transformer.py``), sharded forms
included: with a ``ShardPlan`` (``shard_plan``) a rank runs its blocks of
the reference's layout (``param_specs`` / ``cache_specs``).  Each Mamba2
layer and the shared block gather their leaves over "data" inside the
group's function (rematerialised with ``cfg.remat``, as the reference's
``group_body``); on "model" the Mamba2 layers run a rank's heads
(``ssm.mamba2(..., tp=)``) when they divide it, and the shared block is the
transformer's tensor-parallel attention and SwiGLU
(``transformer._layer_weights``).  Under ``seq -> "model"`` (``plan.seq``)
x and x0 hold the rank's positions: the shared block runs as the dense
family's sequence-parallel layer (K and V gathered, rope from the rank's
first position, the weights whole), and each Mamba2 layer gathers the
positions (``mamba2(..., sp=)``) and runs its heads' scan, or the whole
block, over the uncut sequence.  A sharded decode runs the Mamba2 state
step whole on every rank of "model", so every replica of the whole SSM
state stays equal; the conv state, split over "model" on its channels as in
the reference, is gathered for the step and each rank keeps its block.

The cache is
``{"mamba": {"conv", "ssm"}, "tail": {...}, "attn_k", "attn_v": (groups, B,
cache_len, Hk, Dh), "index": int}``; ``decode_step`` takes ONE token per
call (the reference's Mamba2 state step reads position 0 only) and writes
the cache in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..collectives.autograd import copy_to, reduce_from
from ..collectives.schedules import all_gather_axis
from ..configs.base import ModelConfig
from ..parallel.sharding import Layout
from . import common as C
from . import transformer as T
from .common import DTypes, Params, ParamTree
from .ssm import Mamba2Config, init_mamba2, mamba2, mamba2_init_state, mamba2_specs

# tokens a decode_step call takes: one (see the module docstring)
DECODE_TOKENS = 1


def _dt(cfg: ModelConfig) -> DTypes:
    return DTypes(param=cfg.param_dtype, compute=cfg.compute_dtype)


def _mcfg(cfg: ModelConfig) -> Mamba2Config:
    return Mamba2Config(d_model=cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.mamba_head_dim)


def _attn_cfg(cfg: ModelConfig) -> C.AttnConfig:
    return C.AttnConfig(
        d_model=cfg.d_model,
        heads=cfg.heads,
        kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim,
        causal=True,
        rope_theta=cfg.rope_theta,
    )


def _group_sizes(cfg: ModelConfig) -> Tuple[int, int]:
    g = cfg.shared_attn_every
    groups = cfg.num_layers // g
    return groups, cfg.num_layers - groups * g


def _regroup(tree: Any, groups: int, g: int) -> Any:
    """(groups * g, ...) -> (groups, g, ...) on every leaf."""
    if isinstance(tree, dict):
        return {k: _regroup(v, groups, g) for k, v in tree.items()}
    return tree.reshape((groups, g) + tuple(tree.shape[1:]))


def init(gen: torch.Generator, cfg: ModelConfig, device) -> ParamTree:
    dt = _dt(cfg)
    mcfg = _mcfg(cfg)
    groups, tail = _group_sizes(cfg)
    g = cfg.shared_attn_every

    def mamba_layer(gen):
        return {"ln": C.init_rmsnorm(cfg.d_model, dt, device),
                "mix": init_mamba2(gen, mcfg, dt, device)}

    p: Params = {
        "embed": C.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "groups": _regroup(C.stack_params(gen, groups * g, mamba_layer), groups, g),
        "shared": {
            "in_proj": C.init_linear(gen, 2 * cfg.d_model, cfg.d_model, dt, device),
            "ln1": C.init_rmsnorm(cfg.d_model, dt, device),
            "attn": C.init_attention(gen, _attn_cfg(cfg), dt, device),
            "ln2": C.init_rmsnorm(cfg.d_model, dt, device),
            "ffn": C.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device),
        },
        "final_norm": C.init_rmsnorm(cfg.d_model, dt, device),
    }
    if tail:
        p["tail"] = C.stack_params(gen, tail, mamba_layer)
    return ParamTree(p)


def param_specs(cfg: ModelConfig) -> Params:
    _, tail = _group_sizes(cfg)
    layer = {"ln": C.rmsnorm_specs(), "mix": mamba2_specs(_mcfg(cfg))}
    p: Params = {
        "embed": C.embedding_specs(),
        "groups": _stacked(layer, ("stack", "stack")),
        "shared": {
            "in_proj": C.linear_specs(("fsdp", "embed")),
            "ln1": C.rmsnorm_specs(),
            "attn": C.attention_specs(_attn_cfg(cfg)),
            "ln2": C.rmsnorm_specs(),
            "ffn": C.swiglu_specs(),
        },
        "final_norm": C.rmsnorm_specs(),
    }
    if tail:
        p["tail"] = _stacked(layer, ("stack",))
    return p


def _stacked(tree: Any, lead: Tuple[str, ...]) -> Any:
    if isinstance(tree, dict):
        return {k: _stacked(v, lead) for k, v in tree.items()}
    return lead + tuple(tree)


def cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _, tail = _group_sizes(cfg)
    mamba = {"conv": ("batch", None, "mlp"), "ssm": ("batch", None, None, None)}
    return {
        "mamba": _stacked(mamba, ("stack", "stack")),
        "tail": _stacked(mamba, ("stack",)) if tail else {},
        "attn_k": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
        "attn_v": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
        "index": (),
    }


def shard_plan(cfg: ModelConfig, layout: Layout) -> T.ShardPlan:
    """The shared block's attention and SwiGLU as the transformer's; the
    Mamba2 heads split (``plan.ssm``) when ``out_proj``'s rows are split
    over "model" and the heads divide it."""
    plan = T.tp_plan(cfg, layout, "shared.attn", "shared.ffn", mha=True)
    ssm = (T.on_model(layout, "groups.mix.out_proj.w", -2)
           and _mcfg(cfg).n_heads % plan.tp.size == 0)
    return dataclasses.replace(plan, ssm=ssm)


def _mamba_weights(lp, plan: T.ShardPlan, prefix: str, lead: int, split: bool):
    """A Mamba2 layer's leaves as ``ssm.mamba2`` takes them: with ``split``
    ``out_proj``'s rows kept and the rest gathered whole, the block then
    running a rank's heads; else all whole."""
    return T._layer_weights(lp, plan, prefix, lead, {"mix": split},
                            lambda key: key.endswith("out_proj.w"))


def _attend(sp, cfg: ModelConfig, a_in, positions, dt: DTypes, plan: Optional[T.ShardPlan],
            kv=None, index=None):
    """The shared block's attention; with ``plan.heads`` on a rank's heads
    (and its KV heads of ``kv``), ``wo`` row-parallel; with ``plan.seq`` on
    the rank's positions."""
    acfg = _attn_cfg(cfg)
    split = plan is not None and plan.heads
    if split:
        acfg = T._local_attn(acfg, plan)
        a_in = copy_to(a_in, plan.tp.mesh, plan.tp.axis)
    out, _ = C.attention(sp["attn"], acfg, a_in, positions, dt, kv_cache=kv, cache_index=index,
                         kv_split=plan.kv_split if plan is not None else None,
                         seq=plan.sp if plan is not None else None)
    return reduce_from(out, plan.tp.mesh, plan.tp.axis) if split else out


def _shared_block(sp, cfg: ModelConfig, x, x0, positions, dt: DTypes, kv=None, index=None,
                  plan: Optional[T.ShardPlan] = None):
    """The shared transformer block on concat(x, x0); ``kv`` (this call's
    cache) is written in place."""
    if plan is not None:
        sp = T._layer_weights(sp, plan, "shared.", lead=0)
    h = C.linear(sp["in_proj"], torch.cat([x, x0], dim=-1), dt)
    a_in = C.rmsnorm(sp["ln1"], h)
    h = h + _attend(sp, cfg, a_in, positions, dt, plan, kv, index)
    f_in = C.rmsnorm(sp["ln2"], h)
    h = h + C.swiglu(sp["ffn"], f_in, dt, plan.tp if plan is not None and plan.mlp else None)
    return x + h


def _mamba_layers(params, cfg: ModelConfig):
    """(group or None, [(layer params, prefix, stacked dims)]) in execution
    order; group None is the tail."""
    groups, tail = _group_sizes(cfg)
    for gi in range(groups):
        gp = C.layer_slice(params["groups"], gi)
        yield gi, [(C.layer_slice(gp, li), "groups.", 2) for li in range(cfg.shared_attn_every)]
    if tail:
        yield None, [(C.layer_slice(params["tail"], li), "tail.", 1) for li in range(tail)]


def _group(layers, params, cfg: ModelConfig, x, x0, positions, shared: bool,
           plan: Optional[T.ShardPlan]):
    """A group's Mamba2 layers, then the shared block when ``shared``."""
    dt, mcfg = _dt(cfg), _mcfg(cfg)
    tp = plan.tp if plan is not None and plan.ssm else None
    sp = plan.sp if plan is not None else None
    for lp, prefix, lead in layers:
        if plan is not None:
            lp = _mamba_weights(lp, plan, prefix, lead, tp is not None)
        out, _ = mamba2(lp["mix"], mcfg, C.rmsnorm(lp["ln"], x), dt, tp=tp, sp=sp)
        x = x + out
    if shared:
        x = _shared_block(params["shared"], cfg, x, x0, positions, dt, plan=plan)
    return x


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            plan: Optional[T.ShardPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) int.  Returns (logits, aux = 0).  With
    ``plan.seq`` the tokens, x, x0 and the logits hold the rank's block of
    positions."""
    dt = _dt(cfg)
    x = T.embed_tokens(params, batch["tokens"], dt, plan)
    x0 = x
    B, S, _ = x.shape
    positions = (T.first_position(plan, S) + torch.arange(S, device=x.device))[None].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    for gi, layers in _mamba_layers(params, cfg):
        if remat and gi is not None:  # the reference rematerialises group_body only
            x = checkpoint(_group, layers, params, cfg, x, x0, positions, True, plan,
                           use_reentrant=False)
        else:
            x = _group(layers, params, cfg, x, x0, positions, gi is not None, plan)
    x = C.rmsnorm({"scale": T._outer(params, "final_norm.scale", plan, False)}, x)
    return T.tied_logits(params, x, dt, plan), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> Dict[str, Any]:
    mcfg = _mcfg(cfg)
    groups, tail = _group_sizes(cfg)
    g = cfg.shared_attn_every
    ms = mamba2_init_state(mcfg, batch, cfg.compute_dtype, device)

    def stack(lead):
        return {k: v.expand(lead + tuple(v.shape)).clone(memory_format=torch.contiguous_format)
                for k, v in ms.items()}

    Hk, Dh = cfg.kv_heads, cfg.resolved_head_dim
    kv_shape = (groups, batch, cache_len, Hk, Dh)
    return {
        "mamba": stack((groups, g)),
        "tail": stack((tail,)) if tail else {},
        "attn_k": torch.zeros(kv_shape, dtype=cfg.compute_dtype, device=device),
        "attn_v": torch.zeros(kv_shape, dtype=cfg.compute_dtype, device=device),
        "index": 0,
    }


def _conv_whole(conv: torch.Tensor, mcfg: Mamba2Config, plan: Optional[T.ShardPlan]):
    """A layer's conv state over all channels, and whether it was a
    "model" block (gathered here)."""
    whole = mcfg.d_inner + 2 * mcfg.d_state
    if conv.shape[-1] == whole:
        return conv, False
    return all_gather_axis(conv, plan.tp.mesh, plan.tp.axis, conv.dim() - 1), True


def decode_step(
    params, cfg: ModelConfig, cache: Dict[str, Any], batch: Dict[str, torch.Tensor],
    plan: Optional[T.ShardPlan] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One new token: batch has tokens (B, 1).  Writes the cache in place and
    returns it with ``index`` advanced by one."""
    dt = _dt(cfg)
    mcfg = _mcfg(cfg)
    x = T.embed_tokens(params, batch["tokens"], dt, plan)
    x0 = x
    B, S, _ = x.shape
    if S != DECODE_TOKENS:
        raise ValueError(f"hybrid decode_step takes one token per call (the Mamba2 state step "
                         f"reads one position), got {S}; feed a prompt token by token")
    index = cache["index"]
    positions = torch.full((B, S), index, dtype=torch.long, device=x.device)
    for gi, layers in _mamba_layers(params, cfg):
        states = cache["mamba"] if gi is not None else cache["tail"]
        for li, (lp, prefix, lead) in enumerate(layers):
            if plan is not None:
                lp = _mamba_weights(lp, plan, prefix, lead, False)
            pos = (gi, li) if gi is not None else (li,)
            st = {k: v[pos] for k, v in states.items()}
            conv, split = _conv_whole(st["conv"], mcfg, plan)
            out, nst = mamba2(lp["mix"], mcfg, C.rmsnorm(lp["ln"], x), dt,
                              state={"conv": conv, "ssm": st["ssm"]})
            if split:  # this rank's channels of the new conv state
                n = st["conv"].shape[-1]
                nst["conv"] = nst["conv"].narrow(-1, plan.tp.rank * n, n)
            for k, v in nst.items():
                st[k].copy_(v)
            x = x + out
        if gi is not None:
            x = _shared_block(params["shared"], cfg, x, x0, positions, dt,
                              kv=(cache["attn_k"][gi], cache["attn_v"][gi]), index=index,
                              plan=plan)
    x = C.rmsnorm({"scale": T._outer(params, "final_norm.scale", plan, False)}, x)
    logits = T.tied_logits(params, x, dt, plan)
    return logits, {**cache, "index": index + S}
