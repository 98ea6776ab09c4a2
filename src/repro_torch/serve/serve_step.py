"""Serving steps (counterpart of ``repro/serve/serve_step.py``).

``make_serve_step`` gives the two steps of the reference:

* ``decode_fn(params, cache, batch) -> (logits, cache)``: ``decode_step``
  over S new tokens, writing the cache in place;
* ``prefill_fn(params, batch) -> logits``: the full-context ``forward``
  (through the flash kernel when ``attn_impl="flash"``).  As in the
  reference it returns logits only and writes no cache;
* ``encode_fn(params, enc_embeds) -> enc_out`` for an encoder-decoder
  family (whisper), else None: the encoder, whose output the cache holds
  (on a mesh, this rank's rows of it, as its cache block holds them).

``serve_waves`` answers a ``BatchScheduler``'s requests with those two
steps: per wave, (a) ``prefill_fn`` on the prompts gives the first new
token, (b) ``decode_fn`` fills the cache with the prompt, in one call or,
for a family whose decode takes one token per call (``zoo.decode_tokens``,
the hybrid family), one call per prompt token, (c) one-token ``decode_fn``
steps give the rest.  All slots share one cache ``index``, so
the requests of a wave must have prompts of one length.  A request carries
the reference's extra inputs where its model takes them: a prompt of
embeddings (P, D) in place of tokens and M-RoPE ``positions3`` (3, P) (the
vlm family; the decoded tokens continue at the prompt's largest position
+ 1 + step in all three streams, as Qwen2-VL's text after an image), or
the encoder's ``enc_embeds`` (S_enc, D) (whisper: the prefill is
``forward`` on them and the tokens, and ``encode_fn``'s output fills the
cache's ``enc_out`` before (b)).  (a) and (b) both
produce the last prompt position's logits, through the kernel and the plain
path; each ``Wave`` keeps both so the caller can hold them against each
other.  Serving runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import device as _device
from ..collectives.schedules import all_gather_axis
from ..models.model_zoo import ModelZoo
from ..obs import get_tracer
from ..parallel.sharding import (
    Layout, batch_specs_tree, cache_layout, entry_axes, param_layout, rank_batch, seq_axes,
)


@dataclasses.dataclass(frozen=True)
class ServeArtifacts:
    decode_fn: Callable
    prefill_fn: Callable
    param_layout: Optional[Layout] = None
    cache_layout: Optional[Layout] = None
    encode_fn: Optional[Callable] = None
    plan: Any = None                        # with a mesh: the rank's ShardPlan
    # with a mesh: batch -> the rank's rows (and, with prefill=True, the
    # positions that prefill_plan cuts)
    shard_batch: Optional[Callable] = None
    prefill_plan: Optional[Callable] = None  # with a mesh: () -> the prefill's ShardPlan


def make_serve_step(zoo: ModelZoo, device: _device.DeviceLike = None, mesh=None,
                    batch_example: Optional[Dict[str, Any]] = None,
                    cache_example: Optional[Dict[str, Any]] = None,
                    rules_overrides: Optional[Dict[str, Any]] = None) -> ServeArtifacts:
    """With a mesh, params and cache are each rank's blocks of
    ``param_layout`` / ``cache_layout`` under the default rules and
    ``rules_overrides`` (the reference's).  ``kv_seq`` over some axes cuts
    the cache by position: each rank attends over the positions it holds
    and the ranks combine by logsumexp (``common.cache_attend``); ``batch``
    -> None keeps the cache's rows whole.  ``seq -> "model"`` (the
    reference's activation hint) makes the prefill sequence-parallel for
    every family (``prefill_plan``): each rank takes
    its block of S/|model| positions of every entry, and the logits are
    gathered whole at the end.  Decode and ``encode_fn`` cut no positions."""
    dev = _device.resolve(device)

    def to_dev(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    if mesh is None:
        def decode(params, cache, batch):
            with torch.inference_mode():
                return zoo.decode_step(params, cache, to_dev(batch))

        def prefill(params, batch):
            with torch.inference_mode():
                logits, _ = zoo.forward(params, to_dev(batch))
            return logits

        encode_fn = None
        if zoo.has_encoder:
            def encode_fn(params, enc_embeds):
                with torch.inference_mode():
                    return zoo.encode(params, torch.as_tensor(enc_embeds).to(dev))

        return ServeArtifacts(*_traced_pair(decode, prefill), encode_fn=encode_fn)

    params_lay = param_layout(zoo, mesh, rules_overrides)
    cache_lay = cache_layout(zoo, mesh, cache_example, rules_overrides)
    plan = dataclasses.replace(zoo.shard_plan(params_lay), kv_seq=_kv_seq_axes(cache_lay))
    sizes = params_lay.sizes
    fixed = batch_specs_tree(mesh, batch_example) if batch_example is not None else None

    @functools.lru_cache(maxsize=None)
    def prefill_plan():
        """The prefill's plan, the positions cut over the rules' ``seq``
        axes, read at the first prefill: decode reads no ``seq`` rule."""
        return zoo.shard_plan(params_lay, seq_axes(mesh, rules_overrides))

    def local(batch: Dict[str, Any], seq=()):
        """This rank's rows (and, over ``seq``, its positions of them), and
        the DP axes the rows were cut over."""
        batch = to_dev(batch)
        specs = {**batch_specs_tree(mesh, batch),
                 **{k: v for k, v in (fixed or {}).items() if k in batch}}
        rows_spec = specs[next(k for k in ("tokens", "embeds", "enc_embeds") if k in specs)]
        rows = tuple(a for a in entry_axes(rows_spec[0]) if sizes[a] > 1)
        return rank_batch(mesh, batch, specs, seq), rows

    def whole(logits: torch.Tensor, rows, p) -> torch.Tensor:
        logits = p.gather_logits(logits)
        if p.seq:
            logits = all_gather_axis(logits, mesh, p.seq, 1)
        return all_gather_axis(logits, mesh, rows, 0) if rows else logits

    def decode(params, cache, batch):
        mine, rows = local(batch)
        with torch.inference_mode():
            logits, cache = zoo.decode_step(params, cache, mine, plan)
            return whole(logits, rows, plan), cache

    def shard_batch(batch, prefill: bool = False):
        return local(batch, prefill_plan().seq if prefill else ())[0]

    def prefill(params, batch):
        p = prefill_plan()
        mine, rows = local(batch, p.seq)
        with torch.inference_mode():
            logits, _ = zoo.forward(params, mine, p)
            return whole(logits, rows, p)

    encode_fn = None
    if zoo.has_encoder:
        def encode_fn(params, enc_embeds):
            """This rank's rows of ``enc_out``, as its cache block holds them."""
            mine, _ = local({"enc_embeds": enc_embeds})
            with torch.inference_mode():
                return zoo.encode(params, mine["enc_embeds"], plan)

    return ServeArtifacts(*_traced_pair(decode, prefill), params_lay, cache_lay, encode_fn, plan,
                          shard_batch, prefill_plan)


def _kv_seq_axes(lay: Layout) -> tuple:
    """The axes of size > 1 that cut the attention cache's positions (dim 2
    of its ``k`` leaf)."""
    key = next((k for k in ("k", "attn_k") if k in lay.specs), None)
    if key is None:
        return ()
    return tuple(a for a in entry_axes(lay.specs[key][2]) if lay.sizes[a] > 1)


def _traced(fn: Callable, open_span: Callable) -> Callable:
    """``fn`` inside the span ``open_span(tracer)`` opens, one a call, while
    tracing; otherwise ``fn`` itself is called.  The span names stay
    literals at the call sites, where the span catalog's check finds them."""
    def traced(*args):
        trc = get_tracer()
        if not trc.enabled:
            return fn(*args)
        with open_span(trc):
            return fn(*args)

    return traced


def _traced_pair(decode: Callable, prefill: Callable) -> tuple:
    """(decode_fn, prefill_fn): ``decode`` in a ``serve.decode_step`` span and
    ``prefill`` in a ``serve.prefill`` span (cat ``serve``) while tracing."""
    return (_traced(decode, lambda trc: trc.span("serve.decode_step", cat="serve")),
            _traced(prefill, lambda trc: trc.span("serve.prefill", cat="serve")))


# ---------------------------------------------------------------------------
# Minimal batched request scheduler (continuous batching flavor)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any                 # token array (P,), or embeddings (P, D) (vlm)
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    positions3: Any = None      # M-RoPE positions (3, P) (vlm)
    enc_embeds: Any = None      # encoder frame embeddings (S_enc, D) (whisper)


class BatchScheduler:
    """Greedy slot-based scheduler: fixed decode batch of ``slots``; new
    requests fill free slots; finished requests free them.  Drives the
    decode step with a stable shape (production continuous batching
    reduced to its schedulable core)."""

    def __init__(self, slots: int, eos_id: int = 0):
        self.slots = slots
        self.eos_id = eos_id
        self.active: Dict[int, Request] = {}
        self.queue: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self) -> list[Request]:
        admitted = []
        while self.queue and len(self.active) < self.slots:
            req = self.queue.pop(0)
            free = next(i for i in range(self.slots) if i not in self.active)
            self.active[free] = req
            admitted.append(req)
        return admitted

    def step_tokens(self, sampled: Any) -> None:
        """sampled: (slots,) int array of new tokens for each slot."""
        for slot, req in list(self.active.items()):
            tok = int(sampled[slot])
            req.generated.append(tok)
            if tok == self.eos_id or len(req.generated) >= req.max_new:
                req.done = True
                del self.active[slot]

    @property
    def idle(self) -> bool:
        return not self.active and not self.queue


# ---------------------------------------------------------------------------
# Wave server over the two steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Wave:
    requests: List[Request]
    prompt_len: int
    prefill_last: torch.Tensor   # (slots, vocab) last-position logits of prefill_fn
    fill_last: torch.Tensor      # the same from the cache-filling decode_fn call(s)
    decode_steps: int            # one-token decode_fn calls


def serve_waves(
    zoo: ModelZoo, arts: ServeArtifacts, params, sched: BatchScheduler,
    cache_len: int, *, device: _device.DeviceLike = None,
) -> List[Wave]:
    """Serve every queued request, one wave of up to ``sched.slots``
    equal-length prompts at a time, with greedy (argmax) sampling."""
    dev = _device.resolve(device)
    waves = []
    while not sched.idle:
        admitted = sched.admit()
        P = len(admitted[0].prompt)
        if any(len(r.prompt) != P for r in admitted):
            raise ValueError("a wave needs prompts of one length: its slots share one cache index")
        if P + max(r.max_new for r in admitted) - 1 > cache_len:
            raise ValueError(f"cache_len {cache_len} is too short for prompts of {P} tokens")
        prompt = _slots(sched, "prompt", dev)
        batch = {"embeds": prompt} if prompt.is_floating_point() else {"tokens": prompt.long()}
        positions3 = _slots(sched, "positions3", dev)
        if positions3 is not None:
            batch["positions3"] = positions3.movedim(1, 0)  # (3, slots, P)
        enc_embeds = _slots(sched, "enc_embeds", dev)

        # clone: a view would keep the whole (slots, P, vocab) logits alive
        prefill_batch = batch if enc_embeds is None else {**batch, "enc_embeds": enc_embeds}
        prefill_last = arts.prefill_fn(params, prefill_batch)[:, -1].clone()
        cache = zoo.init_cache(sched.slots, cache_len, device=dev)
        if enc_embeds is not None:
            cache["enc_out"] = arts.encode_fn(params, enc_embeds)
        step = zoo.decode_tokens or P
        for lo in range(0, P, step):
            fill_logits, cache = arts.decode_fn(params, cache, _positions(batch, lo, lo + step))
        fill_last = fill_logits[:, -1].clone()
        del fill_logits
        nxt = prefill_last.argmax(-1)
        sched.step_tokens(nxt.tolist())
        steps = 0
        while sched.active:
            step_batch = {"tokens": nxt[:, None]}
            if positions3 is not None:  # after the prompt's largest position, in all streams
                pos = positions3.amax(dim=(1, 2)) + 1 + steps
                step_batch["positions3"] = pos[None, :, None].expand(3, -1, 1)
            logits, cache = arts.decode_fn(params, cache, step_batch)
            nxt = logits[:, -1].argmax(-1)
            sched.step_tokens(nxt.tolist())
            steps += 1
        waves.append(Wave(admitted, P, prefill_last, fill_last, steps))
    return waves


def _positions(batch: Dict[str, torch.Tensor], lo: int, hi: int) -> Dict[str, torch.Tensor]:
    """Prompt positions [lo, hi) of a wave's batch: dim 1 of tokens and
    embeds, dim 2 of positions3."""
    return {k: v[:, :, lo:hi] if k == "positions3" else v[:, lo:hi] for k, v in batch.items()}


def _slots(sched: BatchScheduler, field: str, dev) -> Optional[torch.Tensor]:
    """One wave's ``field`` of every request, stacked by slot (zeros for a
    free slot), or None when its requests have none."""
    given = {slot: getattr(req, field) for slot, req in sched.active.items()}
    if all(v is None for v in given.values()):
        return None
    if any(v is None for v in given.values()):
        raise ValueError(f"a wave's requests must all give {field} or none")
    rows = {slot: torch.as_tensor(v) for slot, v in given.items()}
    first = next(iter(rows.values()))
    if any(r.shape != first.shape for r in rows.values()):
        raise ValueError(f"a wave's {field} must have one shape: its slots share one cache index")
    out = torch.zeros((sched.slots, *first.shape), dtype=first.dtype)
    for slot, r in rows.items():
        out[slot] = r
    return out.to(dev)
