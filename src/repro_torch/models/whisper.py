"""Whisper-style encoder-decoder backbone, whisper-large-v3 (counterpart of
``repro/models/whisper.py``).

As in the reference, the conv/mel frontend is a stub: the caller gives
frame embeddings ``enc_embeds`` (B, S_enc, D).  The backbone: LayerNorm
pre-norm, tanh-GELU MLPs, sinusoidal encoder positions, learned decoder
positions (``dec_pos``), MHA (kv_heads == heads), decoder cross-attention
over the encoder states.  The tree (``embed``, ``dec_pos``, ``enc_layers``,
``enc_norm``, ``dec_layers`` with ``ln_x`` and ``cross_attn``, ``dec_norm``)
is the reference's, so ``interop.params_from_jax`` carries its parameters
across unchanged.  A Python loop over the stacked layers takes the place
of ``lax.scan``; with ``cfg.remat`` and gradients on, each layer runs under
``torch.utils.checkpoint``.

What the reference does, and the port with it:

* ``common.attention`` applies rope in the self-attention of both stacks.
  ``forward`` passes positions 0 (no rotation); ``decode_step`` passes the
  cache index for every token of the call, so a fill of the whole prompt in
  one call at index 0 equals ``forward`` and step-by-step decode does not.
* The cross-attention's K and V are computed again from ``enc_out`` in
  every decode call (the reference's docstring says once, at prefill).

With ``attn_impl="flash"`` the encoder, the decoder's self-attention and its
cross-attention run the flash kernel in ``forward`` and ``encode``;
``decode_step`` attends on the plain path, as the transformer's does.

API (as ``models/transformer.py``):
    init(gen, cfg, device) / param_specs(cfg) / cache_specs(cfg)
    encode(params, cfg, enc_embeds)               -> enc_out (B, S_enc, D)
    forward(params, cfg, batch)                   -> (logits, 0)
    init_cache(cfg, batch, cache_len, device, enc_len=1500)
    decode_step(params, cfg, cache, batch)        -> (logits, cache)

The cache is ``{"k", "v": (L, B, cache_len, Hk, Dh), "enc_out": (B, enc_len,
D), "index": int}``; the caller sets ``enc_out`` to ``encode``'s output
before the first decode call.  ``decode_step`` writes ``k`` / ``v`` in
place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import common as C
from .common import DTypes, Params, ParamTree


def _dt(cfg: ModelConfig) -> DTypes:
    return DTypes(param=cfg.param_dtype, compute=cfg.compute_dtype)


def _attn_cfg(cfg: ModelConfig, causal: bool) -> C.AttnConfig:
    return C.AttnConfig(
        d_model=cfg.d_model,
        heads=cfg.heads,
        kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim,
        causal=causal,
    )


def _sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) f32: sines then cosines, timescales over ``d // 2 - 1``."""
    log_timescale = math.log(10000.0) / (d // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(d // 2, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_enc_layer(gen, cfg: ModelConfig, device) -> Params:
    dt = _dt(cfg)
    return {
        "ln1": C.init_layernorm(cfg.d_model, dt, device),
        "attn": C.init_attention(gen, _attn_cfg(cfg, False), dt, device),
        "ln2": C.init_layernorm(cfg.d_model, dt, device),
        "mlp": C.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def _init_dec_layer(gen, cfg: ModelConfig, device) -> Params:
    dt = _dt(cfg)
    return {
        "ln1": C.init_layernorm(cfg.d_model, dt, device),
        "self_attn": C.init_attention(gen, _attn_cfg(cfg, True), dt, device),
        "ln_x": C.init_layernorm(cfg.d_model, dt, device),
        "cross_attn": C.init_attention(gen, _attn_cfg(cfg, False), dt, device),
        "ln2": C.init_layernorm(cfg.d_model, dt, device),
        "mlp": C.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig, device) -> ParamTree:
    dt = _dt(cfg)
    p: Params = {
        "embed": C.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "dec_pos": C.trunc_normal(gen, (min(cfg.max_positions, 32768), cfg.d_model), 0.02,
                                  dt.param, device),
        "enc_layers": C.stack_params(gen, cfg.enc_layers,
                                     lambda g: _init_enc_layer(g, cfg, device)),
        "enc_norm": C.init_layernorm(cfg.d_model, dt, device),
        "dec_layers": C.stack_params(gen, cfg.num_layers,
                                     lambda g: _init_dec_layer(g, cfg, device)),
        "dec_norm": C.init_layernorm(cfg.d_model, dt, device),
    }
    return ParamTree(p)


def param_specs(cfg: ModelConfig) -> Params:
    enc_layer = {
        "ln1": C.layernorm_specs(),
        "attn": C.attention_specs(_attn_cfg(cfg, False)),
        "ln2": C.layernorm_specs(),
        "mlp": C.gelu_mlp_specs(),
    }
    dec_layer = {
        "ln1": C.layernorm_specs(),
        "self_attn": C.attention_specs(_attn_cfg(cfg, True)),
        "ln_x": C.layernorm_specs(),
        "cross_attn": C.attention_specs(_attn_cfg(cfg, False)),
        "ln2": C.layernorm_specs(),
        "mlp": C.gelu_mlp_specs(),
    }
    return {
        "embed": C.embedding_specs(),
        "dec_pos": (None, "embed"),
        "enc_layers": C.stacked_specs(enc_layer),
        "enc_norm": C.layernorm_specs(),
        "dec_layers": C.stacked_specs(dec_layer),
        "dec_norm": C.layernorm_specs(),
    }


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


def _run_layers(body, x, layers: list, remat: bool):
    for lp in layers:
        x = checkpoint(body, x, lp, use_reentrant=False) if remat else body(x, lp)
    return x


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    dt = _dt(cfg)
    B, S, D = enc_embeds.shape
    x = enc_embeds.to(cfg.compute_dtype) + _sinusoids(S, D, enc_embeds.device)[None].to(
        cfg.compute_dtype)
    zeros = torch.zeros((B, S), dtype=torch.long, device=x.device)

    def body(x, lp):
        h = C.layernorm(lp["ln1"], x)
        out, _ = C.attention(lp["attn"], _attn_cfg(cfg, False), h, zeros, dt,
                             impl=cfg.attn_impl)
        x = x + out
        h = C.layernorm(lp["ln2"], x)
        return x + C.gelu_mlp(lp["mlp"], h, dt)

    layers = C.layer_slices(params["enc_layers"], cfg.enc_layers)
    x = _run_layers(body, x, layers, cfg.remat and torch.is_grad_enabled())
    return C.layernorm(params["enc_norm"], x)


def _decoder(
    params, cfg: ModelConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
    offset: int = 0, caches: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    dt = _dt(cfg)
    B, S = tokens.shape
    x = C.embed(params["embed"], tokens, dt)
    pos = torch.arange(S, device=x.device) + offset
    x = x + dt.c(params["dec_pos"])[pos][None]
    self_cfg, cross_cfg = _attn_cfg(cfg, True), _attn_cfg(cfg, False)

    if caches is None:
        zeros = torch.zeros((B, S), dtype=torch.long, device=x.device)

        def body(x, lp):
            h = C.layernorm(lp["ln1"], x)
            out, _ = C.attention(lp["self_attn"], self_cfg, h, zeros, dt, impl=cfg.attn_impl)
            x = x + out
            h = C.layernorm(lp["ln_x"], x)
            out, _ = C.attention(lp["cross_attn"], cross_cfg, h, None, dt, xattn_kv=enc_out,
                                 impl=cfg.attn_impl)
            x = x + out
            h = C.layernorm(lp["ln2"], x)
            return x + C.gelu_mlp(lp["mlp"], h, dt)

        layers = C.layer_slices(params["dec_layers"], cfg.num_layers)
        x = _run_layers(body, x, layers, cfg.remat and torch.is_grad_enabled())
        x = C.layernorm(params["dec_norm"], x)
        return C.unembed(params["embed"], x, dt), None

    index = caches["index"]
    # every token of the call at the cache index (the reference's rope)
    at_index = torch.full((B, S), index, dtype=torch.long, device=x.device)
    for i in range(cfg.num_layers):
        lp = C.layer_slice(params["dec_layers"], i)
        h = C.layernorm(lp["ln1"], x)
        out, _ = C.attention(lp["self_attn"], self_cfg, h, at_index, dt,
                             kv_cache=(caches["k"][i], caches["v"][i]), cache_index=index)
        x = x + out
        h = C.layernorm(lp["ln_x"], x)
        out, _ = C.attention(lp["cross_attn"], cross_cfg, h, None, dt, xattn_kv=enc_out)
        x = x + out
        h = C.layernorm(lp["ln2"], x)
        x = x + C.gelu_mlp(lp["mlp"], h, dt)
    x = C.layernorm(params["dec_norm"], x)
    logits = C.unembed(params["embed"], x, dt)
    return logits, {"k": caches["k"], "v": caches["v"], "index": index + S}


def forward(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: enc_embeds (B, S_enc, D), the frame-embedding stub, and tokens
    (B, S).  Returns (logits, 0)."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    logits, _ = _decoder(params, cfg, batch["tokens"], enc_out)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
               enc_len: int = 1500) -> Dict[str, Any]:
    L, Hk, Dh = cfg.num_layers, cfg.kv_heads, cfg.resolved_head_dim
    shape = (L, batch, cache_len, Hk, Dh)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=cfg.compute_dtype,
                               device=device),
        "index": 0,
    }


def cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "k": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("stack", "batch", "kv_seq", "kv_heads", "head_dim"),
        "enc_out": ("batch", "seq", "embed"),
        "index": (),
    }


def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """S new tokens (batch["tokens"] (B, S)) at the cache index, attending
    over the self-attention cache and ``cache["enc_out"]``."""
    if batch["tokens"].shape[1] > cache["k"].shape[2]:
        raise ValueError(f"{batch['tokens'].shape[1]} tokens do not fit a cache of length "
                         f"{cache['k'].shape[2]}")
    logits, new = _decoder(params, cfg, batch["tokens"], cache["enc_out"],
                           offset=cache["index"], caches=cache)
    return logits, {**new, "enc_out": cache["enc_out"]}
