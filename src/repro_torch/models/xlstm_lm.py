"""xLSTM language model, xlstm-125m (counterpart of
``repro/models/xlstm_lm.py``): mLSTM and sLSTM blocks, no FFN, pre-RMSNorm
residual blocks.

Every ``xlstm_slstm_every``-th block is sLSTM (layers 3, 7 and 11 of 12 at
xlstm-125m), the rest mLSTM.  As in the reference both param sets are
stacked on every layer (so the state-dict keys are the reference's tree
paths); the reference's per-layer ``lax.cond`` is a Python branch on the
layer's flag.  The embedding has no sqrt(d_model) factor.  mLSTM's
full-sequence form runs the mLSTM kernel on the card.

API as the dense family (``models/transformer.py``).  The cache is the
recurrent state only, ``{"mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "m"},
"index": int}``, each leaf stacked over all layers in f32; ``decode_step``
takes any number of tokens (the recurrences loop over them) and writes the
cache in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ModelConfig
from . import common as C
from .common import DTypes, Params, ParamTree
from .ssm import XLSTMConfig, init_mlstm, init_slstm, mlstm, mlstm_init_state, slstm, slstm_init_state


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


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) int.  Returns (logits, aux = 0)."""
    dt = _dt(cfg)
    xc = _xcfg(cfg)
    x = C.embed(params["embed"], batch["tokens"], dt)
    for i, is_s in enumerate(_is_slstm_flags(cfg)):
        lp = C.layer_slice(params["layers"], i)
        h = C.rmsnorm(lp["ln"], x)
        block = slstm if is_s else mlstm
        x = x + block(lp["slstm" if is_s else "mlstm"], xc, h, dt)[0]
    x = C.rmsnorm(params["final_norm"], x)
    return C.unembed(params["embed"], x, dt), torch.zeros((), dtype=torch.float32, device=x.device)


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
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """S new tokens: batch has tokens (B, S).  Writes the cache in place and
    returns it with ``index`` advanced by S."""
    dt = _dt(cfg)
    xc = _xcfg(cfg)
    x = C.embed(params["embed"], batch["tokens"], dt)
    for i, is_s in enumerate(_is_slstm_flags(cfg)):
        lp = C.layer_slice(params["layers"], i)
        h = C.rmsnorm(lp["ln"], x)
        kind = "slstm" if is_s else "mlstm"
        st = {k: v[i] for k, v in cache[kind].items()}
        out, new = (slstm if is_s else mlstm)(lp[kind], xc, h, dt, state=st)
        for k, v in new.items():
            st[k].copy_(v)
        x = x + out
    x = C.rmsnorm(params["final_norm"], x)
    logits = C.unembed(params["embed"], x, dt)
    return logits, {**cache, "index": cache["index"] + batch["tokens"].shape[1]}
