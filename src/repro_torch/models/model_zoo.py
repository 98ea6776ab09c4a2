"""Model dispatch (counterpart of ``repro/models/model_zoo.py``).

    zoo = get_model(cfg)                        # dense, moe, hybrid and xlstm families
    params = zoo.init(0)                        # seed or torch.Generator; on the card
    logits, aux = zoo.forward(params, batch)
    cache = zoo.init_cache(batch_size, cache_len)
    logits, cache = zoo.decode_step(params, cache, batch)

    specs = zoo.param_specs()                   # logical-axis tree for sharding
    plan = zoo.shard_plan(layout)               # a rank's view of a sharded Layout
    loss, metrics = zoo.loss(params, batch, plan)

``init`` and ``init_cache`` take ``device=`` (default ``"cuda"``; without a
card they raise unless given ``device="cpu"``).  ``decode_tokens`` is the
number of tokens a ``decode_step`` call must take (1 for the hybrid family,
whose Mamba2 state step reads one position), or None for any number.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch
import torch.distributed as dist

from .. import device as _device
from ..collectives.autograd import reduce_from
from ..collectives.schedules import all_reduce_axis
from ..configs.base import ModelConfig
from . import hybrid, transformer, xlstm_lm
from .common import ParamTree

# where sharding of a family that has none yet is queued
_SHARDING_LATER = "ROADMAP Queue 1 item 10 (sharding for the hybrid and xLSTM families)"


@dataclasses.dataclass(frozen=True)
class ModelZoo:
    cfg: ModelConfig
    _mod: Any

    def init(self, key: Union[int, torch.Generator], *, device: _device.DeviceLike = None):
        dev = _device.resolve(device)
        return self._mod.init(_device.generator(key, dev), self.cfg, dev)

    def forward(self, params, batch, plan=None):
        if plan is None:
            return self._mod.forward(params, self.cfg, batch)
        return self._mod.forward(params, self.cfg, batch, plan)

    def init_cache(self, batch: int, cache_len: int, *, device: _device.DeviceLike = None):
        return self._mod.init_cache(self.cfg, batch, cache_len, _device.resolve(device))

    def decode_step(self, params, cache, batch, plan=None):
        if plan is None:
            return self._mod.decode_step(params, self.cfg, cache, batch)
        return self._mod.decode_step(params, self.cfg, cache, batch, plan)

    def _sharded(self, name: str):
        if not hasattr(self._mod, name):
            raise NotImplementedError(
                f"family {self.cfg.family!r} has no sharded form yet: {_SHARDING_LATER}")
        return getattr(self._mod, name)

    def param_specs(self):
        return self._sharded("param_specs")(self.cfg)

    def cache_specs(self):
        return self._sharded("cache_specs")(self.cfg)

    def shard_plan(self, layout):
        return self._sharded("shard_plan")(self.cfg, layout)

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Whole leaf shapes by state-dict key (the params built on the meta
        device, the counterpart of ``jax.eval_shape`` of ``init``)."""
        tree: ParamTree = self._mod.init(torch.Generator(), self.cfg, torch.device("meta"))
        return {k: tuple(v.shape) for k, v in tree.state_dict().items()}

    @property
    def decode_tokens(self):
        return getattr(self._mod, "DECODE_TOKENS", None)

    def loss(self, params, batch, plan=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy over batch['targets'] with optional
        batch['loss_mask']; adds the aux loss.

        With a ``plan`` the batch is this rank's rows of the global batch
        and the loss is the global one: the masked sum over all ranks' rows
        over the mask's global sum (the mean when there is no mask), on
        every rank.  Its gradient is this rank's share, so summing the
        ranks' gradients over the batch axes gives the global loss's.
        Split logits give the log-partition and the gold logit by a max and
        sums over the model axis, never by gathering the vocab."""
        logits, aux = self.forward(params, batch, plan)
        targets = batch["targets"]
        logits32 = logits.to(torch.float32)
        if plan is not None and plan.head_vocab:
            nll = _vocab_parallel_nll(logits32, targets, plan.tp)
        else:
            logz = torch.logsumexp(logits32, dim=-1)
            gold = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
            nll = logz - gold
        mask = batch.get("loss_mask")
        if plan is None:
            if mask is None:
                loss = torch.mean(nll)
            else:
                loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
            return loss + aux, {"nll": loss, "aux": aux}
        if mask is None:
            total, count = torch.sum(nll), torch.full((), nll.numel(), device=nll.device)
        else:
            total, count = torch.sum(nll * mask), torch.sum(mask)
        sums = torch.stack([total.detach(), count.to(torch.float32)])
        if plan.dp:
            sums = all_reduce_axis(sums, plan.layout.mesh, plan.dp)
        denom = torch.clamp(sums[1], min=1.0)
        mine = total / denom
        loss = sums[0] / denom + (mine - mine.detach())  # the global value, this rank's gradient
        return loss + aux, {"nll": loss.detach(), "aux": aux}


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, tp) -> torch.Tensor:
    """-log softmax(logits)[target] from f32 logits split over ``tp`` on
    the vocab dim (V/tp columns a rank, rank r holding r * V/tp on)."""
    n = logits.shape[-1]
    # the max only steadies exp; logz does not depend on it, so no gradient
    m = all_reduce_axis(logits.detach().amax(-1), tp.mesh, tp.axis, op=dist.ReduceOp.MAX)
    logz = m + torch.log(reduce_from(torch.exp(logits - m[..., None]).sum(-1), tp.mesh, tp.axis))
    local = targets.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return logz - reduce_from(torch.where(mine, gold, 0.0), tp.mesh, tp.axis)


_FAMILIES = {"dense": transformer, "moe": transformer, "hybrid": hybrid, "xlstm": xlstm_lm}

# families of the reference that later slices of the port add
_LATER = {
    "vlm": "the M-RoPE (vlm) slice",
    "whisper": "the whisper slice",
}


def get_model(cfg: ModelConfig) -> ModelZoo:
    if cfg.family in _LATER:
        raise NotImplementedError(f"family {cfg.family!r} comes with {_LATER[cfg.family]}")
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return ModelZoo(cfg, _FAMILIES[cfg.family])
