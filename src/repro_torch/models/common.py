"""Model building blocks (counterpart of ``repro/models/common.py``).

As in the reference, every module is an ``init_*(gen, ..., device)`` that
returns a nested dict of tensors plus an apply function over that dict, and
a ``*_specs`` function that returns the same tree filled with *logical axis
name tuples* for ``parallel.sharding``.
``ParamTree`` turns the finished tree into an ``nn.Module`` whose
``state_dict`` keys are the reference's tree paths joined by ``.``, and
which the apply functions index like the reference's dicts (``p["wq"]``).

Conventions (unchanged from the reference):
  * weights stored (in_dim, out_dim); y = x @ w, with ``torch.matmul``
  * attention heads: q heads H, kv heads Hk (GQA), head_dim Dh
  * dtype policy via ``DTypes(param, compute)``
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..collectives.autograd import copy_to, reduce_from
from ..kernels.flash_attention.ref import NEG_INF, attention_mask

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DTypes:
    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.float32

    def p(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.param)

    def c(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute)


class ParamTree(nn.Module):
    """A param pytree as a module: dict nodes become child modules, leaves
    become parameters.  Gradients are off unless asked for: serving needs
    none; training turns them on (``requires_grad=True``, or
    ``requires_grad_()`` on the tree)."""

    def __init__(self, tree: Mapping[str, Any], requires_grad: bool = False):
        super().__init__()
        for key, node in tree.items():
            if isinstance(node, Mapping):
                self.add_module(key, ParamTree(node, requires_grad))
            else:
                self.register_parameter(key, nn.Parameter(node, requires_grad=requires_grad))

    @classmethod
    def from_state_dict(
        cls, state: Mapping[str, torch.Tensor], requires_grad: bool = False
    ) -> "ParamTree":
        """Rebuild the tree from flat ``a.b.c`` keys (see ``interop``)."""
        tree: Dict[str, Any] = {}
        for path, value in state.items():
            node = tree
            *parents, leaf = path.split(".")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = value
        return cls(tree, requires_grad)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return [*self._parameters, *self._modules]


def trunc_normal(
    gen: torch.Generator, shape: Tuple[int, ...], scale: float,
    dtype: torch.dtype, device: torch.device,
) -> torch.Tensor:
    """Normal cut at ±2 standard deviations, then scaled (as the reference)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Linear / norm / embedding
# ---------------------------------------------------------------------------


def init_linear(gen, d_in: int, d_out: int, dt: DTypes, device) -> Params:
    scale = 1.0 / math.sqrt(d_in)
    return {"w": trunc_normal(gen, (d_in, d_out), scale, dt.param, device)}


def linear_specs(axes: Tuple[Optional[str], Optional[str]]) -> Params:
    return {"w": axes}


def linear(p: Params, x: torch.Tensor, dt: DTypes) -> torch.Tensor:
    return torch.matmul(x, dt.c(p["w"]))


def init_rmsnorm(d: int, dt: DTypes, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dt.param, device=device)}


def rmsnorm_specs() -> Params:
    return {"scale": (None,)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(dtype)


def init_embedding(gen, vocab: int, d: int, dt: DTypes, device) -> Params:
    return {"table": trunc_normal(gen, (vocab, d), d ** -0.5, dt.param, device)}


def embedding_specs() -> Params:
    return {"table": ("vocab", "embed")}


def embed(p: Params, ids: torch.Tensor, dt: DTypes) -> torch.Tensor:
    return dt.c(p["table"])[ids]


def unembed(p: Params, x: torch.Tensor, dt: DTypes) -> torch.Tensor:
    return torch.matmul(x, dt.c(p["table"]).T)


# ---------------------------------------------------------------------------
# Tensor-parallel forms on a rank's local shards (the "model" mesh axis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TP:
    """The tensor-parallel axis of a mesh: rank ``rank`` of ``size``."""
    mesh: Any
    axis: str = "model"

    @property
    def size(self) -> int:
        return self.mesh.shape[self.mesh.mesh_dim_names.index(self.axis)]

    @property
    def rank(self) -> int:
        return self.mesh.get_local_rank(self.axis)


def column_linear(p: Params, x: torch.Tensor, dt: DTypes, tp: TP) -> torch.Tensor:
    """x (replicated over ``tp``) @ w[:, local columns]: the local slice of
    the output; x's gradient is summed over ``tp``."""
    return linear(p, copy_to(x, tp.mesh, tp.axis), dt)


def row_linear(p: Params, x: torch.Tensor, dt: DTypes, tp: TP) -> torch.Tensor:
    """x[..., local rows] @ w[local rows]: partial sums, all-reduced over
    ``tp`` into the whole output."""
    return reduce_from(linear(p, x, dt), tp.mesh, tp.axis)


def vocab_embed(p: Params, ids: torch.Tensor, dt: DTypes, tp: TP) -> torch.Tensor:
    """Lookup in a vocab-parallel table (V/tp rows a rank): the rows this
    rank holds, zeros for the others, all-reduced over ``tp``."""
    table = dt.c(p["table"])
    n = table.shape[0]
    local = ids - tp.rank * n
    mine = (local >= 0) & (local < n)
    out = torch.where(mine[..., None], table[local.clamp(0, n - 1)], 0)
    return reduce_from(out, tp.mesh, tp.axis)


def vocab_unembed(p: Params, x: torch.Tensor, dt: DTypes, tp: TP) -> torch.Tensor:
    """Logits of this rank's V/tp vocab rows (tied embedding)."""
    return unembed(p, copy_to(x, tp.mesh, tp.axis), dt)


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split, not interleaved; f32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                     # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs        # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention config / init (the dense family's paths live in models/transformer.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None        # sliding-window span (local layers)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    use_bias: bool = False
    softmax_scale: Optional[float] = None


def attention_specs(cfg: AttnConfig) -> Params:
    p: Params = {
        "wq": linear_specs(("fsdp", "heads")),
        "wk": linear_specs(("fsdp", "heads")),
        "wv": linear_specs(("fsdp", "heads")),
        "wo": linear_specs(("heads", "fsdp")),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_specs()
        p["k_norm"] = rmsnorm_specs()
    return p


def init_attention(gen, cfg: AttnConfig, dt: DTypes, device) -> Params:
    D, H, Hk, Dh = cfg.d_model, cfg.heads, cfg.kv_heads, cfg.head_dim
    p: Params = {
        "wq": init_linear(gen, D, H * Dh, dt, device),
        "wk": init_linear(gen, D, Hk * Dh, dt, device),
        "wv": init_linear(gen, D, Hk * Dh, dt, device),
        "wo": init_linear(gen, H * Dh, D, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(Dh, dt, device)
        p["k_norm"] = init_rmsnorm(Dh, dt, device)
    return p


# ---------------------------------------------------------------------------
# Plain attention (both families' non-kernel paths; the hybrid's shared block)
# ---------------------------------------------------------------------------


def masked_attention(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """GQA attention with f32 scores and softmax, output in q's dtype.
    q (B, Sq, H, Dh), k/v (B, Skv, Hk, Dh); mask (Sq, Skv) is True where
    visible.  Masked scores are -1e30, so a row that sees no key averages v."""
    B, Sq, H, Dh = q.shape
    Hk = k.shape[2]
    qg = (q.to(torch.float32) * scale).reshape(B, Sq, Hk, H // Hk, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool, window: Optional[int], scale: float, q_offset: int = 0,
) -> torch.Tensor:
    """Scaled dot-product attention with GQA, the reference's "ref" branch;
    with ``causal=True`` and ``q_offset`` the cache index it is also the
    reference's ``_decode_sdpa``.  q (B, Sq, H, Dh); k/v (B, Skv, Hk, Dh)."""
    mask = attention_mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    return masked_attention(q, k, v, mask, scale)


def attention(
    p: Params,
    cfg: AttnConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    dt: DTypes,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Self-attention with rope at ``positions`` (B, S), without qk-norm
    (the one caller, the hybrid's shared block, has none).  Returns (output,
    kv cache).  Without a cache it attends within x;
    with ``kv_cache=(k, v)`` (B, S_max, Hk, Dh) and ``cache_index`` (a host
    int, the filled length) it writes this call's keys and values into the
    cache in place and attends over it.  The write start is clamped so the
    update fits while the mask keeps the unclamped index, as
    ``dynamic_update_slice_in_dim`` does in the reference."""
    B, S, _ = x.shape
    H, Hk, Dh = cfg.heads, cfg.kv_heads, cfg.head_dim
    q = apply_rope(linear(p["wq"], x, dt).reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = apply_rope(linear(p["wk"], x, dt).reshape(B, S, Hk, Dh), positions, cfg.rope_theta)
    v = linear(p["wv"], x, dt).reshape(B, S, Hk, Dh)
    scale = cfg.softmax_scale or (1.0 / math.sqrt(Dh))
    if kv_cache is not None:
        ck, cv = kv_cache
        start = min(max(cache_index, 0), ck.shape[1] - S)
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
        out = sdpa(q, ck, cv, causal=True, window=cfg.window, scale=scale, q_offset=cache_index)
        return linear(p["wo"], out.reshape(B, S, H * Dh), dt), (ck, cv)
    out = sdpa(q, k, v, causal=cfg.causal, window=cfg.window, scale=scale)
    return linear(p["wo"], out.reshape(B, S, H * Dh), dt), None


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_swiglu(gen, d: int, d_ff: int, dt: DTypes, device) -> Params:
    return {
        "wi": init_linear(gen, d, d_ff, dt, device),
        "wg": init_linear(gen, d, d_ff, dt, device),
        "wo": init_linear(gen, d_ff, d, dt, device),
    }


def swiglu_specs() -> Params:
    return {
        "wi": linear_specs(("fsdp", "mlp")),
        "wg": linear_specs(("fsdp", "mlp")),
        "wo": linear_specs(("mlp", "fsdp")),
    }


def swiglu(p: Params, x: torch.Tensor, dt: DTypes, tp: Optional[TP] = None) -> torch.Tensor:
    """With ``tp`` the hidden dim is split over it: wi / wg column-parallel,
    wo row-parallel."""
    if tp is None:
        h = torch.nn.functional.silu(linear(p["wg"], x, dt)) * linear(p["wi"], x, dt)
        return linear(p["wo"], h, dt)
    x = copy_to(x, tp.mesh, tp.axis)
    h = torch.nn.functional.silu(linear(p["wg"], x, dt)) * linear(p["wi"], x, dt)
    return row_linear(p["wo"], h, dt, tp)


# ---------------------------------------------------------------------------
# Stacked-layer utilities (the layer loop walks the leading n dim)
# ---------------------------------------------------------------------------


def stack_params(gen, n: int, init_fn: Callable[[Any], Params]) -> Params:
    """init_fn(gen) -> layer params; returns the tree with a leading n dim."""
    layers = [init_fn(gen) for _ in range(n)]

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([nd[k] for nd in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return stack(layers)


def stacked_specs(layer_specs: Params) -> Params:
    """Prefix every leaf's logical axes with the 'stack' (layer) axis."""
    if isinstance(layer_specs, tuple):
        return ("stack",) + layer_specs
    return {k: stacked_specs(v) for k, v in layer_specs.items()}


def layer_slice(p: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (the ``lax.scan`` xs slice)."""
    if isinstance(p, (Mapping, ParamTree)):
        return {k: layer_slice(p[k], i) for k in p.keys()}
    return p[i]


def layer_slices(p: Any, n: int) -> list:
    """All ``n`` layers of a stacked tree, each leaf unbound once.  Indexing
    a leaf that requires grad n times (``layer_slice``) gives n backward
    nodes that each write a zero tensor as large as the whole stack;
    ``torch.unbind`` has one backward, a ``stack``."""
    if isinstance(p, (Mapping, ParamTree)):
        per_key = {k: layer_slices(p[k], n) for k in p.keys()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(p, 0))
