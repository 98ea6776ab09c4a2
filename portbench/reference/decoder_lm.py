"""Plain PyTorch reference of the decoder-only LM that ``repro_torch``
trains (its dense and MoE families), with its loss and its AdamW.

Written from the model's equations, for the benchmark alone: it imports
nothing of ``repro_torch``, nothing of the JAX package, and no kernel.  It
computes in float32 (TF32 off; ``precision="fp8"`` is the control below),
with plain matrix products, no cache, and activations recomputed layer by
layer (``torch.utils.checkpoint``), attention over blocks of queries and the
loss over blocks of tokens, so that a full-width layer fits the card
beside its float32 state.

The model, for tokens x of a batch of rows:

* embedding rows scaled by sqrt(d_model); then per layer
  h = rms(x) * ln1, x += attention(h), h = rms(x) * ln2, x += ffn(h);
  logits = (rms(x) * final_norm) @ lm_head; rms eps 1e-6;
* attention: q, k, v = h Wq, h Wk, h Wv in heads of head_dim (kv_heads of
  them, each shared by heads / kv_heads query heads); with ``qk_norm`` an
  rms norm over head_dim on q and k; rotary embedding on the halves of
  head_dim (frequencies theta^(-2i/head_dim), positions 0..S-1); causal
  softmax(q k^T / sqrt(head_dim)) v; out @ Wo;
* dense ffn: (silu(h Wg) * (h Wi)) Wo;
* MoE ffn over the T tokens of a microbatch: router probabilities
  softmax(h Wr); each token's top_k experts (ties to the lower index), their
  probabilities renormalised to sum 1; each expert takes at most
  C = round(capacity_factor * T * top_k / E) assignments (Python's round,
  half to even), in the order token by token, choice by choice; an
  assignment past C is dropped (gate 0); out = sum of gate * expert's
  SwiGLU, plus, with ``num_shared_experts`` n, every token through one
  shared SwiGLU of width n * d_ff (ungated); aux = aux_loss_coeff * E * sum_e mean_t(probs[t, e]) *
  (choices of e / (T * top_k)), summed over the layers;
* loss = mean over tokens of logsumexp(logits) - logits[target], plus aux.

A step averages the loss and the gradient over its microbatches, then
AdamW: the gradient clipped to a global norm of ``grad_clip``; moments in
float32; lr by linear warmup then a cosine to ``min_lr_frac``; bias
correction; decoupled weight decay on every stored array of two or more
dims (a stacked array of norm scales, (layers, d), counts as two, as
``repro_torch``'s optimizer states); the new value rounded to the
parameters' stored type (bf16 in the benchmark's cells).

The control (``precision="fp8"``): every matrix product, attention's two
included, takes its operands rounded to float8 e4m3 (the gradient to e5m2
in the backward), each tensor scaled by its absolute maximum, as fp8
training does; the rest as above.

Parameters are a flat dict keyed by the names ``param_layout`` gives,
the layer leaves stacked on a leading layer dim.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

EPS = 1e-6
ATTN_BLOCK = 1024     # queries a block of attention
LOSS_BLOCK = 2048     # tokens a block of the loss


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------


def param_layout(m: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """name -> (shape, init, scale): ``normal`` leaves are a normal draw cut
    at +-2 and scaled by ``scale``, ``ones`` leaves are ones."""
    L, D, V = m["num_layers"], m["d_model"], m["vocab"]
    H, Hk, Dh = m["heads"], m["kv_heads"], m["head_dim"]
    out: Dict[str, Tuple[Tuple[int, ...], str, float]] = {
        "embed.table": ((V, D), "normal", D ** -0.5),
        "layers.ln1.scale": ((L, D), "ones", 1.0),
        "layers.attn.wq.w": ((L, D, H * Dh), "normal", D ** -0.5),
        "layers.attn.wk.w": ((L, D, Hk * Dh), "normal", D ** -0.5),
        "layers.attn.wv.w": ((L, D, Hk * Dh), "normal", D ** -0.5),
        "layers.attn.wo.w": ((L, H * Dh, D), "normal", (H * Dh) ** -0.5),
    }
    if m.get("qk_norm"):
        out["layers.attn.q_norm.scale"] = ((L, Dh), "ones", 1.0)
        out["layers.attn.k_norm.scale"] = ((L, Dh), "ones", 1.0)
    out["layers.ln2.scale"] = ((L, D), "ones", 1.0)
    moe = m.get("moe")
    if moe:
        E, Fe = moe["num_experts"], moe["d_ff"]
        out["layers.moe.router.w"] = ((L, D, E), "normal", D ** -0.5)
        out["layers.moe.wi"] = ((L, E, D, Fe), "normal", D ** -0.5)
        out["layers.moe.wg"] = ((L, E, D, Fe), "normal", D ** -0.5)
        out["layers.moe.wo"] = ((L, E, Fe, D), "normal", Fe ** -0.5)
        Fs = Fe * moe["num_shared_experts"]
        if Fs:
            out["layers.moe.shared.wi.w"] = ((L, D, Fs), "normal", D ** -0.5)
            out["layers.moe.shared.wg.w"] = ((L, D, Fs), "normal", D ** -0.5)
            out["layers.moe.shared.wo.w"] = ((L, Fs, D), "normal", Fs ** -0.5)
    else:
        Ff = m["d_ff"]
        out["layers.ffn.wi.w"] = ((L, D, Ff), "normal", D ** -0.5)
        out["layers.ffn.wg.w"] = ((L, D, Ff), "normal", D ** -0.5)
        out["layers.ffn.wo.w"] = ((L, Ff, D), "normal", Ff ** -0.5)
    out["final_norm.scale"] = ((D,), "ones", 1.0)
    if not m.get("tie_embeddings", False):
        out["lm_head.w"] = ((D, V), "normal", D ** -0.5)
    return out


# ---------------------------------------------------------------------------
# matrix products: float32, or the fp8 control
# ---------------------------------------------------------------------------


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round_fp8(a, torch.float8_e4m3fn), _round_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round_fp8(g, torch.float8_e5m2)
        return torch.matmul(qg, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), qg)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if b.dim() == 2 and a.dim() > 2:
        return _Fp8MatMul.apply(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], b.shape[1])
    return _Fp8MatMul.apply(a, b)


MATMULS: Dict[str, MatMul] = {"float32": torch.matmul, "fp8": fp8_matmul}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, Dh) rotated by position, on the halves of Dh."""
    S, Dh = x.shape[1], x.shape[-1]
    freqs = theta ** -(torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
                mm: MatMul) -> torch.Tensor:
    """Queries q0.. of q (B, H, Sb, Dh) over keys 0..q0+Sb-1 (B, H, n, Dh)."""
    Sb, n = q.shape[2], k.shape[2]
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(q0, q0 + Sb, device=q.device)[:, None]
    kpos = torch.arange(n, device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v)


def attention(w: Weights, l: int, m: Dict[str, Any], h: torch.Tensor, mm: MatMul) -> torch.Tensor:
    B, S, _ = h.shape
    H, Hk, Dh = m["heads"], m["kv_heads"], m["head_dim"]
    q = mm(h, w["layers.attn.wq.w"][l]).reshape(B, S, H, Dh)
    k = mm(h, w["layers.attn.wk.w"][l]).reshape(B, S, Hk, Dh)
    v = mm(h, w["layers.attn.wv.w"][l]).reshape(B, S, Hk, Dh)
    if m.get("qk_norm"):
        q = rms(q, w["layers.attn.q_norm.scale"][l])
        k = rms(k, w["layers.attn.k_norm.scale"][l])
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    group = H // Hk
    q = q.transpose(1, 2)
    k = k.repeat_interleave(group, dim=2).transpose(1, 2)
    v = v.repeat_interleave(group, dim=2).transpose(1, 2)
    outs = []
    for q0 in range(0, S, ATTN_BLOCK):
        qb = q[:, :, q0:q0 + ATTN_BLOCK]
        end = q0 + qb.shape[2]
        args = (qb, k[:, :, :end], v[:, :, :end], q0, mm)
        outs.append(checkpoint(_attn_block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attn_block(*args))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * Dh)
    return mm(out, w["layers.attn.wo.w"][l])


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
           mm: MatMul) -> torch.Tensor:
    return mm(F.silu(mm(x, wg)) * mm(x, wi), wo)


def capacity(moe: Dict[str, Any], tokens: int) -> int:
    return int(max(1, round(moe["capacity_factor"] * tokens * moe["top_k"] / moe["num_experts"])))


def moe_ffn(w: Weights, l: int, m: Dict[str, Any], h: torch.Tensor,
            mm: MatMul) -> Tuple[torch.Tensor, torch.Tensor]:
    moe = m["moe"]
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    T, E, K = x.shape[0], moe["num_experts"], moe["top_k"]
    probs = torch.softmax(mm(x, w["layers.moe.router.w"][l]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :K], idx[:, :K]
    gates = (vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)).reshape(-1)
    chosen = torch.bincount(idx.reshape(-1), minlength=E).to(torch.float32) / (T * K)
    aux = moe["aux_loss_coeff"] * E * torch.sum(probs.mean(0) * chosen)
    flat = idx.reshape(-1)                                   # assignment j = t * K + k
    place = torch.cumsum(F.one_hot(flat, E), dim=0).gather(1, flat[:, None])[:, 0] - 1
    kept = place < capacity(moe, T)
    token = torch.arange(T, device=x.device).repeat_interleave(K)
    out = torch.zeros_like(x)
    wi, wg, wo = w["layers.moe.wi"][l], w["layers.moe.wg"][l], w["layers.moe.wo"][l]
    for e in range(E):
        j = torch.nonzero(kept & (flat == e))[:, 0]
        if j.numel() == 0:
            continue
        t = token[j]
        y = swiglu(x[t], wi[e], wg[e], wo[e], mm)
        out = out.index_add(0, t, y * gates[j, None])
    if moe["num_shared_experts"]:
        out = out + swiglu(x, w["layers.moe.shared.wi.w"][l], w["layers.moe.shared.wg.w"][l],
                           w["layers.moe.shared.wo.w"][l], mm)
    return out.reshape(B, S, D), aux


def layer(w: Weights, l: int, m: Dict[str, Any], x: torch.Tensor,
          mm: MatMul) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + attention(w, l, m, rms(x, w["layers.ln1.scale"][l]), mm)
    h = rms(x, w["layers.ln2.scale"][l])
    if m.get("moe"):
        out, aux = moe_ffn(w, l, m, h, mm)
    else:
        out = swiglu(h, w["layers.ffn.wi.w"][l], w["layers.ffn.wg.w"][l],
                     w["layers.ffn.wo.w"][l], mm)
        aux = x.new_zeros(())
    return x + out, aux


def _nll_sum(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
             mm: MatMul) -> torch.Tensor:
    logits = mm(x, head)
    gold = logits.gather(1, targets[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss(w: Weights, m: Dict[str, Any], tokens: torch.Tensor, targets: torch.Tensor,
         mm: MatMul = torch.matmul) -> torch.Tensor:
    """The microbatch's loss: mean next-token cross entropy plus the
    layers' aux."""
    x = w["embed.table"][tokens] * math.sqrt(m["d_model"])
    aux = x.new_zeros(())
    grad = torch.is_grad_enabled()
    for l in range(m["num_layers"]):
        if grad:
            x, a = checkpoint(layer, w, l, m, x, mm, use_reentrant=False)
        else:
            x, a = layer(w, l, m, x, mm)
        aux = aux + a
    D = x.shape[-1]
    x = rms(x, w["final_norm.scale"]).reshape(-1, D)
    head = w["embed.table"].T if m.get("tie_embeddings", False) else w["lm_head.w"]
    tgt = targets.reshape(-1)
    total = x.new_zeros(())
    for i in range(0, x.shape[0], LOSS_BLOCK):
        args = (x[i:i + LOSS_BLOCK], head, tgt[i:i + LOSS_BLOCK], mm)
        total = total + (checkpoint(_nll_sum, *args, use_reentrant=False) if grad
                         else _nll_sum(*args))
    return total / x.shape[0] + aux


# ---------------------------------------------------------------------------
# AdamW and the steps
# ---------------------------------------------------------------------------


CHUNK = 1 << 25  # elements an update works on at once


def _chunks(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``t`` along its first dim of about ``CHUNK`` elements each."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    return list(t.split(max(1, CHUNK // (t.numel() // t.shape[0])), 0))


def lr_at(opt: Dict[str, Any], step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_frac * lr`` at ``total_steps``."""
    warm = opt["warmup_steps"]
    if step < warm:
        return opt["lr"] * step / max(1.0, warm)
    prog = min(max((step - warm) / max(1.0, opt["total_steps"] - warm), 0.0), 1.0)
    f = opt["min_lr_frac"]
    return opt["lr"] * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * prog)))


def leaf_slices(name: str, t: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """The weights a leaf holds: a stacked leaf's layers one by one."""
    if name.startswith("layers."):
        return [(f"{name}[{i}]", t[i]) for i in range(t.shape[0])]
    return [(name, t)]


def leaf_norms(named: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    """The float32 norm of each weight (``leaf_slices``), times ``scale``."""
    return {k: float(torch.linalg.vector_norm(s.to(torch.float32))) * scale
            for name, t in named.items() for k, s in leaf_slices(name, t)}


def train(w0: Weights, m: Dict[str, Any], opt: Dict[str, Any], steps: List[List[Tuple]],
          precision: str = "float32", stored: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """``len(steps)`` AdamW steps from the weights ``w0`` (as stored), each
    step a list of (tokens, targets) microbatches.  Returns each step's
    loss, each weight's norm of the first step's gradient as AdamW takes it
    (clipped), and of its change over the steps."""
    mm = MATMULS[precision]
    w = {k: v.to(torch.float32, copy=True).requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for step, micro in enumerate(steps, start=1):
        total = 0.0
        for tokens, targets in micro:
            value = loss(w, m, tokens, targets, mm) / len(micro)
            value.backward()
            total += value.item()
        losses.append(total)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(v.grad.square().sum()) for v in w.values()))
            clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12))
            if step == 1:
                first_grad = leaf_norms({k: v.grad for k, v in w.items()}, clip)
            lr = lr_at(opt, step)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in w.items():
                for pc, gc, mc, nc in zip(*(_chunks(t) for t in (p, p.grad, mu[k], nu[k]))):
                    g = gc * clip
                    mc.mul_(b1).add_(g, alpha=1 - b1)
                    nc.mul_(b2).add_(g.square(), alpha=1 - b2)
                    upd = (mc / c1) / ((nc / c2).sqrt() + eps)
                    if p.dim() >= 2:
                        upd = upd + wd * pc
                    pc.copy_((pc - lr * upd).to(stored).to(torch.float32))
                p.grad = None
    change: Dict[str, float] = {}
    for k in w:
        change.update(leaf_norms({k: w[k].detach() - w0[k].to(torch.float32)}))
    return {"loss": losses, "grad": first_grad, "change": change}
