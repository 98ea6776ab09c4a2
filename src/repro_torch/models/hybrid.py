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

API as the dense family (``models/transformer.py``).  The cache is
``{"mamba": {"conv", "ssm"}, "tail": {...}, "attn_k", "attn_v": (groups, B,
cache_len, Hk, Dh), "index": int}``; ``decode_step`` takes ONE token per
call (the reference's Mamba2 state step reads position 0 only) and writes
the cache in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import common as C
from .common import DTypes, Params, ParamTree
from .ssm import Mamba2Config, init_mamba2, mamba2, mamba2_init_state

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


def _shared_block(sp, cfg: ModelConfig, x, x0, positions, dt: DTypes, kv=None, index=None):
    """The shared transformer block on concat(x, x0); ``kv`` (this call's
    cache) is written in place."""
    h = C.linear(sp["in_proj"], torch.cat([x, x0], dim=-1), dt)
    a_in = C.rmsnorm(sp["ln1"], h)
    attn_out, _ = C.attention(sp["attn"], _attn_cfg(cfg), a_in, positions, dt,
                              kv_cache=kv, cache_index=index)
    h = h + attn_out
    f_in = C.rmsnorm(sp["ln2"], h)
    h = h + C.swiglu(sp["ffn"], f_in, dt)
    return x + h


def _mamba_layers(params, cfg: ModelConfig):
    """(group or None, layer params) in execution order; group None is the tail."""
    groups, tail = _group_sizes(cfg)
    for gi in range(groups):
        gp = C.layer_slice(params["groups"], gi)
        yield gi, [C.layer_slice(gp, li) for li in range(cfg.shared_attn_every)]
    if tail:
        yield None, [C.layer_slice(params["tail"], li) for li in range(tail)]


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) int.  Returns (logits, aux = 0)."""
    dt = _dt(cfg)
    mcfg = _mcfg(cfg)
    x = C.embed(params["embed"], batch["tokens"], dt)
    x0 = x
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for gi, layers in _mamba_layers(params, cfg):
        for lp in layers:
            out, _ = mamba2(lp["mix"], mcfg, C.rmsnorm(lp["ln"], x), dt)
            x = x + out
        if gi is not None:
            x = _shared_block(params["shared"], cfg, x, x0, positions, dt)
    x = C.rmsnorm(params["final_norm"], x)
    return C.unembed(params["embed"], x, dt), torch.zeros((), dtype=torch.float32, device=x.device)


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


def decode_step(
    params, cfg: ModelConfig, cache: Dict[str, Any], batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One new token: batch has tokens (B, 1).  Writes the cache in place and
    returns it with ``index`` advanced by one."""
    dt = _dt(cfg)
    mcfg = _mcfg(cfg)
    x = C.embed(params["embed"], batch["tokens"], dt)
    x0 = x
    B, S, _ = x.shape
    if S != DECODE_TOKENS:
        raise ValueError(f"hybrid decode_step takes one token per call (the Mamba2 state step "
                         f"reads one position), got {S}; feed a prompt token by token")
    index = cache["index"]
    positions = torch.full((B, S), index, dtype=torch.long, device=x.device)
    for gi, layers in _mamba_layers(params, cfg):
        states = cache["mamba"] if gi is not None else cache["tail"]
        for li, lp in enumerate(layers):
            pos = (gi, li) if gi is not None else (li,)
            st = {k: v[pos] for k, v in states.items()}
            out, nst = mamba2(lp["mix"], mcfg, C.rmsnorm(lp["ln"], x), dt, state=st)
            for k, v in nst.items():
                st[k].copy_(v)
            x = x + out
        if gi is not None:
            x = _shared_block(params["shared"], cfg, x, x0, positions, dt,
                              kv=(cache["attn_k"][gi], cache["attn_v"][gi]), index=index)
    x = C.rmsnorm(params["final_norm"], x)
    logits = C.unembed(params["embed"], x, dt)
    return logits, {**cache, "index": index + S}
