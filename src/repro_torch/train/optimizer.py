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

On CUDA tensors the norm and the update are the multi-tensor kernels of
``kernels/adamw`` (three launches a step: the sum of squares, its root, the
update), which read each byte of g, p, mu and nu once and write p, mu and nu
once; they compute what the chunked code computes, op for op in f32.  On
the meta device a dry run traces the same three operators, which launch
nothing there.  On the CPU the chunked code runs: it is their plain
version, ``_sum_sq_plain`` and ``_update_plain``.  A call on the card counts
``optimizer.fused`` (leaves, elements, launches) when a tracer is on.

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

from ..kernels.adamw import adamw as fused
from ..obs import get_tracer

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


def _on_kernels(t: torch.Tensor) -> bool:
    """Whether a step on ``t`` runs the kernels: on a CUDA device, or on the
    meta device, where a dry run traces their operators."""
    return t.device.type in ("cuda", "meta")


def _sum_sq(grads: Iterable[torch.Tensor], root: bool = False) -> torch.Tensor:
    """Σ g² over the leaves in f32 (its square root with ``root``); on CUDA
    tensors the kernels' (summed in f64), on CPU ones ``_sum_sq_plain``."""
    grads = list(grads)
    if any(_on_kernels(g) for g in grads):
        return fused.sum_sq(grads, root)
    return _sum_sq_plain(grads, root)


def _sum_sq_plain(grads: Iterable[torch.Tensor], root: bool = False) -> torch.Tensor:
    total = None
    for g in grads:
        for c in _chunks(g):
            sq = torch.sum(torch.square(c.to(torch.float32)))
            total = sq if total is None else total + sq
    return torch.sqrt(total) if root else total


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, in f32 (0-d tensor on the grads' device)."""
    return _sum_sq(grads, root=True)


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


def step_scalars(cfg: AdamWConfig, step: int) -> Tuple[float, float, float]:
    """Step ``step``'s learning rate and bias corrections 1 - b^step, in f32."""
    f = np.float32
    return (lr_schedule(cfg, step), float(f(1) - f(cfg.b1) ** f(step)),
            float(f(1) - f(cfg.b2) ** f(step)))


def kernel_scalars(cfg: AdamWConfig, lr: float, b1c: float, b2c: float) -> "fused.Hyper":
    """The update kernel's scalars (rounded to f32 at the launch, as
    PyTorch rounds the plain version's Python scalars)."""
    return fused.Hyper(clip=cfg.grad_clip, lr=lr, b1=cfg.b1, b2=cfg.b2, omb1=1 - cfg.b1,
                       omb2=1 - cfg.b2, b1c=b1c, b2c=b2c, eps=cfg.eps, wd=cfg.weight_decay)


def apply(
    cfg: AdamWConfig, state: AdamWState, params: torch.nn.Module, grads: Dict[str, torch.Tensor],
    grad_norm: Optional[torch.Tensor] = None,
) -> Tuple[torch.nn.Module, AdamWState, Dict[str, Any]]:
    """One step.  Returns (params, state, {"grad_norm": tensor, "lr": float});
    params and the moments are updated in place.  ``grad_norm`` is the
    gradient's global norm when the caller has it (a sharded gradient)."""
    named = dict(params.named_parameters())
    step = state.step + 1
    lr, b1c, b2c = step_scalars(cfg, step)
    before = sum(fused.LAUNCHES.values())
    gnorm = global_norm(grads[n] for n in named) if grad_norm is None else grad_norm
    if not any(_on_kernels(p) for p in named.values()):
        _update_plain(cfg, named, grads, state.mu, state.nu, gnorm, lr, b1c, b2c)
        return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
    leaves = [fused.Leaf(p, grads[n], state.mu[n], state.nu[n], p.dim() >= 2)
              for n, p in named.items()]
    fused.update(leaves, gnorm, kernel_scalars(cfg, lr, b1c, b2c))
    trc = get_tracer()
    if trc.enabled:
        trc.counter("optimizer.fused", leaves=len(leaves),
                    elements=sum(leaf.p.numel() for leaf in leaves),
                    launches=sum(fused.LAUNCHES.values()) - before)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}


def _update_plain(cfg: AdamWConfig, named: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  mu_all: Dict[str, torch.Tensor], nu_all: Dict[str, torch.Tensor],
                  gnorm: torch.Tensor, lr: float, b1c: float, b2c: float) -> None:
    """The update in PyTorch ops, chunk by chunk, in place: the kernels'
    plain version."""
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    with torch.no_grad():
        for name, p in named.items():
            decay = p.dim() >= 2  # decoupled decay on matrices only
            for pc, gc, mu, nu in zip(_chunks(p), _chunks(grads[name]), _chunks(mu_all[name]),
                                      _chunks(nu_all[name])):
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
