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
    shard_plan(cfg, layout)                       -> ShardPlan
    encode(params, cfg, enc_embeds, plan=None)    -> enc_out (B, S_enc, D)
    forward(params, cfg, batch, plan=None)        -> (logits, 0)
    init_cache(cfg, batch, cache_len, device, enc_len=1500)
    decode_step(params, cfg, cache, batch, plan=None) -> (logits, cache)

With a ``ShardPlan`` each layer gathers its leaves over "data" inside its
(rematerialised) function, and on "model" the encoder's attention, the
decoder's self- and cross-attention run a rank's heads (wq / wk / wv
column-parallel, wo row-parallel; the encoder states enter each
cross-attention through ``copy_to``) when the heads divide it, the MLPs
split their hidden dim, and the tied embedding splits the vocab when it
divides (51866 does over 2, not over 4; ``sanitize_specs`` keeps it whole
then).  The cache holds a rank's rows and KV heads, and its rows of
``enc_out``.

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

from ..collectives.autograd import copy_to, reduce_from
from ..configs.base import ModelConfig
from ..parallel.sharding import Layout
from . import common as C
from . import transformer as T
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


def shard_plan(cfg: ModelConfig, layout: Layout) -> T.ShardPlan:
    """The decoder's self-attention and MLP leaves decide for every
    attention and MLP block (all have the same shapes)."""
    return T.tp_plan(cfg, layout, "dec_layers.self_attn", "dec_layers.mlp", ("wi",), mha=True)


def _run_layers(body, x, layers: list, remat: bool):
    for lp in layers:
        x = checkpoint(body, x, lp, use_reentrant=False) if remat else body(x, lp)
    return x


def _attend(p, acfg: C.AttnConfig, x, positions, dt: DTypes, plan: Optional[T.ShardPlan],
            **kw) -> torch.Tensor:
    """``common.attention``; with ``plan.heads`` on a rank's heads, the
    encoder states (``xattn_kv``) entering the split region as x does; with
    ``plan.seq`` (no cache) on the rank's positions of x and of the encoder
    states, every rank's keys and values gathered."""
    if plan is not None and plan.seq:
        return C.attention(p, acfg, x, positions, dt, seq=plan.sp, **kw)[0]
    if plan is None or not plan.heads:
        return C.attention(p, acfg, x, positions, dt, **kw)[0]
    mesh, axis = plan.tp.mesh, plan.tp.axis
    if kw.get("xattn_kv") is not None:
        kw["xattn_kv"] = copy_to(kw["xattn_kv"], mesh, axis)
    out, _ = C.attention(p, T._local_attn(acfg, plan), copy_to(x, mesh, axis), positions, dt,
                         **kw)
    return reduce_from(out, mesh, axis)


def _mlp(p, x, dt: DTypes, plan: Optional[T.ShardPlan]) -> torch.Tensor:
    return C.gelu_mlp(p, x, dt, plan.tp if plan is not None and plan.mlp else None)


def _weights(lp, plan: Optional[T.ShardPlan], prefix: str):
    return lp if plan is None else T._layer_weights(lp, plan, prefix)


def _norm(params, key: str, x, plan: Optional[T.ShardPlan]) -> torch.Tensor:
    return C.layernorm({k: T._outer(params, f"{key}.{k}", plan, False)
                        for k in ("scale", "bias")}, x)


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
           plan: Optional[T.ShardPlan] = None) -> torch.Tensor:
    dt = _dt(cfg)
    B, S, D = enc_embeds.shape
    start = T.first_position(plan, S)  # the frames' first position
    pos = _sinusoids(start + S, D, enc_embeds.device)[start:]
    x = enc_embeds.to(cfg.compute_dtype) + pos[None].to(cfg.compute_dtype)
    zeros = torch.zeros((B, S), dtype=torch.long, device=x.device)

    def body(x, lp):
        lp = _weights(lp, plan, "enc_layers.")
        h = C.layernorm(lp["ln1"], x)
        x = x + _attend(lp["attn"], _attn_cfg(cfg, False), h, zeros, dt, plan,
                        impl=cfg.attn_impl)
        h = C.layernorm(lp["ln2"], x)
        return x + _mlp(lp["mlp"], h, dt, plan)

    layers = C.layer_slices(params["enc_layers"], cfg.enc_layers)
    x = _run_layers(body, x, layers, cfg.remat and torch.is_grad_enabled())
    return _norm(params, "enc_norm", x, plan)


def _decoder(
    params, cfg: ModelConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
    offset: int = 0, caches: Optional[Dict[str, Any]] = None,
    plan: Optional[T.ShardPlan] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    dt = _dt(cfg)
    B, S = tokens.shape
    x = T.embed_tokens(params, tokens, dt, plan)
    pos = torch.arange(S, device=x.device) + offset + T.first_position(plan, S)
    x = x + dt.c(T._outer(params, "dec_pos", plan, False))[pos][None]
    self_cfg, cross_cfg = _attn_cfg(cfg, True), _attn_cfg(cfg, False)

    if caches is None:
        zeros = torch.zeros((B, S), dtype=torch.long, device=x.device)

        def body(x, lp):
            lp = _weights(lp, plan, "dec_layers.")
            h = C.layernorm(lp["ln1"], x)
            x = x + _attend(lp["self_attn"], self_cfg, h, zeros, dt, plan, impl=cfg.attn_impl)
            h = C.layernorm(lp["ln_x"], x)
            x = x + _attend(lp["cross_attn"], cross_cfg, h, None, dt, plan, xattn_kv=enc_out,
                            impl=cfg.attn_impl)
            h = C.layernorm(lp["ln2"], x)
            return x + _mlp(lp["mlp"], h, dt, plan)

        layers = C.layer_slices(params["dec_layers"], cfg.num_layers)
        x = _run_layers(body, x, layers, cfg.remat and torch.is_grad_enabled())
        x = _norm(params, "dec_norm", x, plan)
        return T.tied_logits(params, x, dt, plan), None

    index = caches["index"]
    # every token of the call at the cache index (the reference's rope)
    at_index = torch.full((B, S), index, dtype=torch.long, device=x.device)
    for i in range(cfg.num_layers):
        lp = _weights(C.layer_slice(params["dec_layers"], i), plan, "dec_layers.")
        h = C.layernorm(lp["ln1"], x)
        x = x + _attend(lp["self_attn"], self_cfg, h, at_index, dt, plan,
                        kv_cache=(caches["k"][i], caches["v"][i]), cache_index=index,
                        kv_split=plan.kv_split if plan is not None else None)
        h = C.layernorm(lp["ln_x"], x)
        x = x + _attend(lp["cross_attn"], cross_cfg, h, None, dt, plan, xattn_kv=enc_out)
        h = C.layernorm(lp["ln2"], x)
        x = x + _mlp(lp["mlp"], h, dt, plan)
    x = _norm(params, "dec_norm", x, plan)
    logits = T.tied_logits(params, x, dt, plan)
    return logits, {"k": caches["k"], "v": caches["v"], "index": index + S}


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            plan: Optional[T.ShardPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: enc_embeds (B, S_enc, D), the frame-embedding stub, and tokens
    (B, S).  Returns (logits, 0).  With ``plan.seq`` both hold the rank's
    block of positions (and so do the logits)."""
    enc_out = encode(params, cfg, batch["enc_embeds"], plan)
    logits, _ = _decoder(params, cfg, batch["tokens"], enc_out, plan=plan)
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
                batch: Dict[str, torch.Tensor],
                plan: Optional[T.ShardPlan] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """S new tokens (batch["tokens"] (B, S)) at the cache index, attending
    over the self-attention cache and ``cache["enc_out"]``."""
    split = plan.kv_split if plan is not None else None
    cache_len = cache["k"].shape[2] * (split.size if split is not None else 1)
    if batch["tokens"].shape[1] > cache_len:
        raise ValueError(f"{batch['tokens'].shape[1]} tokens do not fit a cache of length "
                         f"{cache_len}")
    logits, new = _decoder(params, cfg, batch["tokens"], cache["enc_out"],
                           offset=cache["index"], caches=cache, plan=plan)
    return logits, {**new, "enc_out": cache["enc_out"]}
