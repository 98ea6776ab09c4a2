"""Decoder-only transformer LM, dense family (counterpart of
``repro/models/transformer.py``).

Covers qwen3-8b (qk-norm, untied lm_head), llama3.2-3b and granite-20b
(MQA).  Layers are stacked with a leading ``L`` dim, as in the reference;
a Python loop over that dim takes the place of ``lax.scan``.  With
``cfg.remat`` and gradients on, each layer runs under
``torch.utils.checkpoint`` (non-reentrant): nothing inside a layer is kept
for the backward, which recomputes it, as ``jax.checkpoint`` with
``nothing_saveable`` does in the reference.  MoE and M-RoPE configs raise:
they come with later slices.

API (used by serve):
    init(gen, cfg, device)                  -> params (ParamTree)
    forward(params, cfg, batch)             -> (logits, aux_loss)
    init_cache(cfg, batch, cache_len, dev)  -> cache
    decode_step(params, cfg, cache, batch)  -> (logits, cache)

The cache is ``{"k", "v": (L, B, cache_len, Hk, Dh), "index": int}``.
``index`` is a host int (the reference keeps a device scalar) so a decode
step needs no device sync.  ``decode_step`` writes the cache in place: the
reference donates its cache to the jitted step, and this is the
counterpart, so the cache passed in must not be used again.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from . import common as C
from .common import DTypes, Params, ParamTree

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


def check_supported(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers come with the MoE slice")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE comes with the vlm slice")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} is not one of {ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: ModelConfig, device) -> Params:
    dt = _dt(cfg)
    return {
        "ln1": C.init_rmsnorm(cfg.d_model, dt, device),
        "attn": C.init_attention(gen, _attn_cfg(cfg), dt, device),
        "ln2": C.init_rmsnorm(cfg.d_model, dt, device),
        "ffn": C.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


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
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed(params, cfg: ModelConfig, batch, dt: DTypes) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"].to(cfg.compute_dtype)
    x = C.embed(params["embed"], batch["tokens"], dt)
    # sqrt(d_model) rounded to the compute dtype first, as the reference
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype, device=x.device)


def _unembed(params, cfg: ModelConfig, x, dt: DTypes) -> torch.Tensor:
    x = C.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        return C.unembed(params["embed"], x, dt)
    return C.linear(params["lm_head"], x, dt)


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


def _attention_dynwin(p, acfg: C.AttnConfig, x, positions, is_global: bool, dt, impl: str):
    """Attention with the sliding window switched per layer.  ``"flash"``
    without a window takes the CUDA kernels, forward and backward (on one
    card there is no mesh condition); everything else is the plain path."""
    B, S, _ = x.shape
    H, Dh = acfg.heads, acfg.head_dim
    q, k, v = _qkv(p, acfg, x, positions, dt)
    if impl == "flash" and acfg.window is None:
        out = flash_attention(q, k, v, causal=acfg.causal, scale=1.0 / math.sqrt(Dh))
        return C.linear(p["wo"], out.reshape(B, S, H * Dh), dt)
    qpos = torch.arange(S, device=x.device)[:, None]
    kpos = torch.arange(S, device=x.device)[None, :]
    mask = kpos <= qpos
    if acfg.window is not None and not is_global:
        mask = mask & (kpos > qpos - acfg.window)
    out = C.masked_attention(q, k, v, mask, 1.0 / math.sqrt(Dh))
    return C.linear(p["wo"], out.reshape(B, S, H * Dh), dt)


def _layer_fwd(lp, cfg: ModelConfig, x, positions, is_global: bool, dt: DTypes):
    h = C.rmsnorm(lp["ln1"], x)
    x = x + _attention_dynwin(lp["attn"], _attn_cfg(cfg), h, positions, is_global, dt, cfg.attn_impl)
    h = C.rmsnorm(lp["ln2"], x)
    return x + C.swiglu(lp["ffn"], h, dt)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) int [or embeds (B, S, D)], positions (B, S)
    optional.  Returns (logits, aux); aux is 0 for the dense family."""
    check_supported(cfg)
    dt = _dt(cfg)
    x = _embed(params, cfg, batch, dt)
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    layers = C.layer_slices(params["layers"], cfg.num_layers)
    for lp, is_global in zip(layers, _is_global_flags(cfg)):
        if remat:
            x = checkpoint(_layer_fwd, lp, cfg, x, positions, is_global, dt, use_reentrant=False)
        else:
            x = _layer_fwd(lp, cfg, x, positions, is_global, dt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(params, cfg, x, dt), aux


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


def _decode_attention(p, acfg: C.AttnConfig, x, positions, is_global: bool, ck, cv, index: int, dt):
    """Attention of S new tokens over the cache of one layer; ck/cv
    (B, cache_len, Hk, Dh) are written in place at ``index``."""
    B, S, _ = x.shape
    H, Dh = acfg.heads, acfg.head_dim
    q, k, v = _qkv(p, acfg, x, positions, dt)
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
    out = C.masked_attention(q, ck, cv, mask, 1.0 / math.sqrt(Dh))
    return C.linear(p["wo"], out.reshape(B, S, H * Dh), dt)


def decode_step(
    params, cfg: ModelConfig, cache: Dict[str, Any], batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """S new tokens: batch has tokens (B, S) [or embeds (B, S, D)].  Writes
    the cache in place and returns it with ``index`` advanced by S."""
    check_supported(cfg)
    dt = _dt(cfg)
    x = _embed(params, cfg, batch, dt)
    B, S, _ = x.shape
    index = cache["index"]
    if S > cache["k"].shape[2]:
        raise ValueError(f"{S} tokens do not fit a cache of length {cache['k'].shape[2]}")
    positions = (index + torch.arange(S, device=x.device))[None].expand(B, S)
    acfg = _attn_cfg(cfg)
    for i, is_global in enumerate(_is_global_flags(cfg)):
        lp = C.layer_slice(params["layers"], i)
        h = C.rmsnorm(lp["ln1"], x)
        x = x + _decode_attention(
            lp["attn"], acfg, h, positions, is_global, cache["k"][i], cache["v"][i], index, dt
        )
        h = C.rmsnorm(lp["ln2"], x)
        x = x + C.swiglu(lp["ffn"], h, dt)
    logits = _unembed(params, cfg, x, dt)
    return logits, {"k": cache["k"], "v": cache["v"], "index": index + S}
