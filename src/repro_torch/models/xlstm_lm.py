"""xLSTM language model, xlstm-125m (counterpart of
``repro/models/xlstm_lm.py``): mLSTM and sLSTM blocks, no FFN, pre-RMSNorm
residual blocks.

Every ``xlstm_slstm_every``-th block is sLSTM (layers 3, 7 and 11 of 12 at
xlstm-125m), the rest mLSTM.  As in the reference both param sets are
stacked on every layer (so the state-dict keys are the reference's tree
paths); the reference's per-layer ``lax.cond`` is a Python branch on the
layer's flag.  The embedding has no sqrt(d_model) factor.  mLSTM's
full-sequence form runs the mLSTM kernel on the card.

API as the dense family (``models/transformer.py``), sharded forms
included: with a ``ShardPlan`` (``shard_plan``) each layer gathers the
leaves of the block it runs over "data" inside its function (rematerialised
with ``cfg.remat``), and on "model" the mLSTM and sLSTM run a rank's heads
(``ssm.mlstm`` / ``ssm.slstm`` with ``tp``; ``plan.ssm``) when they divide
it.  The embedding and the logits split the vocab as the transformer's.
Under ``seq -> "model"`` (``plan.seq``) the residual stream holds the rank's
positions between the blocks, and each block gathers them (``sp``) and runs
on its heads or whole, as the layout has it.  A sharded
decode runs the recurrences whole on every rank of "model", so every
replica of the states, whole over "model" in ``cache_specs`` as in the
reference, stays equal.  The cache is the
recurrent state only, ``{"mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "m"},
"index": int}``, each leaf stacked over all layers in f32; ``decode_step``
takes any number of tokens (the recurrences loop over them) and writes the
cache in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel.sharding import Layout
from . import common as C
from . import transformer as T
from .common import DTypes, Params, ParamTree
from .ssm import (
    XLSTMConfig, init_mlstm, init_slstm, mlstm, mlstm_init_state, mlstm_specs, slstm,
    slstm_init_state, slstm_specs,
)

# the leaves of a block that keep their "model" block when the heads split
_HEAD_LEAVES = ("wq", "wk", "wv", "wo_gate", "out", "wz")


def _dt(cfg: ModelConfig) -> DTypes:
    return DTypes(param=cfg.param_dtype, compute=cfg.compute_dtype)


def _xcfg(cfg: ModelConfig) -> XLSTMConfig:
    return XLSTMConfig(d_model=cfg.d_model, heads=cfg.heads)


def _is_slstm_flags(cfg: ModelConfig) -> List[bool]:
    every = cfg.xlstm_slstm_every
    return [(i % every) == (every - 1) for i in range(cfg.num_layers)]


def init(gen: torch.Generator, cfg: ModelConfig, device) -> ParamTree:
    xc = _xcfg(cfg)
    dt = _dt(cfg)

    def layer(gen):
        return {
            "ln": C.init_rmsnorm(cfg.d_model, dt, device),
            "mlstm": init_mlstm(gen, xc, dt, device),
            "slstm": init_slstm(gen, xc, dt, device),
        }

    p: Params = {
        "embed": C.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "layers": C.stack_params(gen, cfg.num_layers, layer),
        "final_norm": C.init_rmsnorm(cfg.d_model, dt, device),
    }
    return ParamTree(p)


def param_specs(cfg: ModelConfig) -> Params:
    xc = _xcfg(cfg)
    layer = {"ln": C.rmsnorm_specs(), "mlstm": mlstm_specs(xc), "slstm": slstm_specs(xc)}
    return {
        "embed": C.embedding_specs(),
        "layers": C.stacked_specs(layer),
        "final_norm": C.rmsnorm_specs(),
    }


def cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "mlstm": {"C": ("stack", "batch", None, None, None), "n": ("stack", "batch", None, None),
                  "m": ("stack", "batch", None)},
        "slstm": {"c": ("stack", "batch", None, None), "n": ("stack", "batch", None),
                  "m": ("stack", "batch", None)},
        "index": (),
    }


def shard_plan(cfg: ModelConfig, layout: Layout) -> T.ShardPlan:
    """``plan.ssm``: the mLSTM and sLSTM heads split over "model" (their
    head projections' columns and ``out``'s rows split, the heads
    dividing it)."""
    plan = T.tp_plan(cfg, layout, None, None)
    ssm = plan.tp is not None and cfg.heads % plan.tp.size == 0 and all(
        T.on_model(layout, f"layers.{b}.{k}.w", d)
        for b, leaves in (("mlstm", ("wq", "wk", "wv", "wo_gate")), ("slstm", ("wz", "wo_gate")))
        for k, d in [(leaf, -1) for leaf in leaves] + [("out", -2)])
    return dataclasses.replace(plan, mlp=False, ssm=ssm)


def _layer(lp, i: int, cfg: ModelConfig, x, is_s: bool, plan: Optional[T.ShardPlan],
           split: bool, state=None):
    """Layer ``i``: pre-norm, then its sLSTM or mLSTM block (on a rank's
    heads when ``split``; on the gathered positions under ``plan.seq``);
    (x, new state)."""
    kind = "slstm" if is_s else "mlstm"
    lp = {"ln": lp["ln"], kind: lp[kind]}
    if plan is not None:
        lp = T._layer_weights(lp, plan, "layers.", 1, {kind: split},
                              lambda key: key.split(".")[-2] in _HEAD_LEAVES)
    tp = plan.tp if split else None
    sp = plan.sp if plan is not None else None
    out, new = (slstm if is_s else mlstm)(lp[kind], _xcfg(cfg), C.rmsnorm(lp["ln"], x),
                                          _dt(cfg), state=state, tp=tp, sp=sp)
    return x + out, new


def _final(params, cfg: ModelConfig, x, plan: Optional[T.ShardPlan]) -> torch.Tensor:
    x = C.rmsnorm({"scale": T._outer(params, "final_norm.scale", plan, False)}, x)
    return T.tied_logits(params, x, _dt(cfg), plan)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            plan: Optional[T.ShardPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) int.  Returns (logits, aux = 0)."""
    x = T.embed_tokens(params, batch["tokens"], _dt(cfg), plan)
    split = plan is not None and plan.ssm
    remat = cfg.remat and torch.is_grad_enabled()
    for i, is_s in enumerate(_is_slstm_flags(cfg)):
        lp = C.layer_slice(params["layers"], i)
        if remat:
            x, _ = checkpoint(_layer, lp, i, cfg, x, is_s, plan, split, use_reentrant=False)
        else:
            x, _ = _layer(lp, i, cfg, x, is_s, plan, split)
    return _final(params, cfg, x, plan), torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> Dict[str, Any]:
    """Recurrent state only: O(1) in the context length (``cache_len`` is
    not used)."""
    xc = _xcfg(cfg)
    L = cfg.num_layers

    def stack(state):
        return {k: v.expand((L,) + tuple(v.shape)).clone(memory_format=torch.contiguous_format)
                for k, v in state.items()}

    return {"mlstm": stack(mlstm_init_state(xc, batch, device)),
            "slstm": stack(slstm_init_state(xc, batch, device)), "index": 0}


def decode_step(
    params, cfg: ModelConfig, cache: Dict[str, Any], batch: Dict[str, torch.Tensor],
    plan: Optional[T.ShardPlan] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """S new tokens: batch has tokens (B, S).  Writes the cache in place and
    returns it with ``index`` advanced by S."""
    x = T.embed_tokens(params, batch["tokens"], _dt(cfg), plan)
    for i, is_s in enumerate(_is_slstm_flags(cfg)):
        st = {k: v[i] for k, v in cache["slstm" if is_s else "mlstm"].items()}
        x, new = _layer(C.layer_slice(params["layers"], i), i, cfg, x, is_s, plan, False, st)
        for k, v in new.items():
            st[k].copy_(v)
    logits = _final(params, cfg, x, plan)
    return logits, {**cache, "index": cache["index"] + batch["tokens"].shape[1]}
