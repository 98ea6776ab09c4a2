"""AdamW, written out (counterpart of ``repro/train/optimizer.py``; not
``torch.optim``).

As in the reference: moments in ``moment_dtype`` (f32) whatever the param
dtype, decoupled weight decay on leaves with ``ndim >= 2`` only (a stacked
norm scale (L, D) counts as 2-D there too), clipping by the global norm of
the gradients, warmup then cosine decay to ``min_lr_frac``, and the update
computed in f32 and cast back to the param dtype.

Params are the ``ParamTree`` (any ``nn.Module``); gradients and moments are
flat dicts keyed by its ``named_parameters`` names.  The reference returns
new arrays; ``apply`` updates params and moments **in place** (and returns
them), walking large leaves in chunks along their first dim, so that the f32
temporaries of a step stay a few hundred MB instead of the size of the
largest leaf (28 x 3072 x 8192 at llama3.2-3b: 2.8 GB per f32 copy).
``step`` is a host int, so the learning rate is known on the host and a step
needs no device sync.

Sharded (``gspmd_fsdp``): params, grads and moments are a rank's blocks,
the moments laid out as their params (``state_specs``); the update is
elementwise, so it runs on the blocks as is, and ``sharded_global_norm``
gives the norm of the whole gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# elements per chunk of the in-place update
CHUNK = 1 << 25


class AdamWState(NamedTuple):
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moment_dtype: Any = torch.float32


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Warmup then cosine; in f32, as the reference computes it."""
    f = np.float32
    s = f(step)
    warm = s / f(max(1.0, cfg.warmup_steps))
    prog = (s - f(cfg.warmup_steps)) / f(max(1.0, cfg.total_steps - cfg.warmup_steps))
    prog = np.clip(prog, f(0.0), f(1.0))
    cos = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * f(0.5) * (f(1) + np.cos(f(math.pi) * prog))
    return float(f(cfg.lr) * (warm if s < cfg.warmup_steps else cos))


def init(cfg: AdamWConfig, params: torch.nn.Module) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
                for n, p in params.named_parameters()}

    return AdamWState(step=0, mu=zeros(), nu=zeros())


def _chunks(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``t`` along its first dim, each of at most ~CHUNK elements."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    rows = max(1, CHUNK // (t.numel() // t.shape[0]))
    return list(t.split(rows, 0))


def _sum_sq(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    total = None
    for g in grads:
        for c in _chunks(g):
            sq = torch.sum(torch.square(c.to(torch.float32)))
            total = sq if total is None else total + sq
    return total


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, in f32 (0-d tensor on the grads' device)."""
    return torch.sqrt(_sum_sq(grads))


def state_specs(param_specs: Dict[str, Any]) -> AdamWState:
    """The moments' specs: their params' (the step is a host int)."""
    return AdamWState(step=(), mu=dict(param_specs), nu=dict(param_specs))


def sharded_global_norm(grads: Dict[str, torch.Tensor], layout) -> torch.Tensor:
    """The global norm of a gradient held as blocks of ``layout``: each
    leaf's local sum of squares, summed over the mesh axes that split it (a
    leaf whole on some axes counts once, not once a rank); one all-reduce
    per set of axes."""
    from ..collectives.schedules import all_reduce_axis
    from ..parallel.sharding import entry_axes

    sizes, names = layout.sizes, layout.mesh.mesh_dim_names
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for key, g in grads.items():
        axes = {a for e in layout.specs[key] for a in entry_axes(e) if sizes[a] > 1}
        groups.setdefault(tuple(a for a in names if a in axes), []).append(g)
    total = None
    for axes, leaves in groups.items():
        sq = _sum_sq(leaves)
        if axes:
            sq = all_reduce_axis(sq, layout.mesh, axes)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply(
    cfg: AdamWConfig, state: AdamWState, params: torch.nn.Module, grads: Dict[str, torch.Tensor],
    grad_norm: Optional[torch.Tensor] = None,
) -> Tuple[torch.nn.Module, AdamWState, Dict[str, Any]]:
    """One step.  Returns (params, state, {"grad_norm": tensor, "lr": float});
    params and the moments are updated in place.  ``grad_norm`` is the
    gradient's global norm when the caller has it (a sharded gradient)."""
    named = dict(params.named_parameters())
    gnorm = global_norm(grads[n] for n in named) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    f = np.float32
    b1c = float(f(1) - f(cfg.b1) ** f(step))
    b2c = float(f(1) - f(cfg.b2) ** f(step))
    with torch.no_grad():
        for name, p in named.items():
            decay = p.dim() >= 2  # decoupled decay on matrices only
            for pc, gc, mu, nu in zip(_chunks(p), _chunks(grads[name]), _chunks(state.mu[name]),
                                      _chunks(state.nu[name])):
                g = gc.to(torch.float32) * scale
                mu.mul_(cfg.b1).add_(g.to(mu.dtype), alpha=1 - cfg.b1)
                nu.mul_(cfg.b2).add_(torch.square(g).to(nu.dtype), alpha=1 - cfg.b2)
                denom = (nu.to(torch.float32) / b2c).sqrt_().add_(cfg.eps)
                delta = (mu.to(torch.float32) / b1c).div_(denom)
                p32 = pc.to(torch.float32)  # pc itself when the param is f32
                if decay:
                    delta.add_(p32, alpha=cfg.weight_decay)
                p32.sub_(delta.mul_(lr))
                if p32 is not pc:
                    pc.copy_(p32)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
