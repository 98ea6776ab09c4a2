"""Model dispatch (counterpart of ``repro/models/model_zoo.py``).

    zoo = get_model(cfg)                        # dense, hybrid and xlstm families
    params = zoo.init(0)                        # seed or torch.Generator; on the card
    logits, aux = zoo.forward(params, batch)
    cache = zoo.init_cache(batch_size, cache_len)
    logits, cache = zoo.decode_step(params, cache, batch)

``init`` and ``init_cache`` take ``device=`` (default ``"cuda"``; without a
card they raise unless given ``device="cpu"``).  ``decode_tokens`` is the
number of tokens a ``decode_step`` call must take (1 for the hybrid family,
whose Mamba2 state step reads one position), or None for any number.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from .. import device as _device
from ..configs.base import ModelConfig
from . import hybrid, transformer, xlstm_lm


@dataclasses.dataclass(frozen=True)
class ModelZoo:
    cfg: ModelConfig
    _mod: Any

    def init(self, key: Union[int, torch.Generator], *, device: _device.DeviceLike = None):
        dev = _device.resolve(device)
        return self._mod.init(_device.generator(key, dev), self.cfg, dev)

    def forward(self, params, batch):
        return self._mod.forward(params, self.cfg, batch)

    def init_cache(self, batch: int, cache_len: int, *, device: _device.DeviceLike = None):
        return self._mod.init_cache(self.cfg, batch, cache_len, _device.resolve(device))

    def decode_step(self, params, cache, batch):
        return self._mod.decode_step(params, self.cfg, cache, batch)

    @property
    def decode_tokens(self):
        return getattr(self._mod, "DECODE_TOKENS", None)

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over batch['targets'] with optional
        batch['loss_mask']; adds the aux loss."""
        logits, aux = self.forward(params, batch)
        targets = batch["targets"]
        logits32 = logits.to(torch.float32)
        logz = torch.logsumexp(logits32, dim=-1)
        gold = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
        nll = logz - gold
        mask = batch.get("loss_mask")
        if mask is None:
            loss = torch.mean(nll)
        else:
            loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return loss + aux, {"nll": loss, "aux": aux}


_FAMILIES = {"dense": transformer, "hybrid": hybrid, "xlstm": xlstm_lm}

# families of the reference that later slices of the port add
_LATER = {
    "moe": "the MoE slice",
    "vlm": "the M-RoPE (vlm) slice",
    "whisper": "the whisper slice",
}


def get_model(cfg: ModelConfig) -> ModelZoo:
    if cfg.family in _LATER:
        raise NotImplementedError(f"family {cfg.family!r} comes with {_LATER[cfg.family]}")
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return ModelZoo(cfg, _FAMILIES[cfg.family])
