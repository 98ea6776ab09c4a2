"""The device trace of a few whole steps, reduced to what the metrics read.

Frozen copies, adapted to spans of their own: ``labels`` is
``chip_profile.py``'s ``_moe_labels`` (a ``record_function`` label patched
round a function of the port while the trace runs; the port carries none),
``busy_us`` its ``_device_us`` (the union of the device operations'
intervals; a label's device-side span is no operation), and the
profiler's use is its ``_profiled`` (``torch.profiler`` over CPU and CUDA,
the host clock to a synchronised end).

``Trace`` keeps, for the profiled steps: each device operation (name,
start, end in us), each label's device time (``device_time_total`` of the
label's host event), each flash kernel call's shape (recorded by the
wrapper's patch), and the host events, for the idle gaps' breakdown.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

# module -> {function: label}: the spans the trace puts round the port's own
# functions (each module's functions are looked up by name at call time)
LABELS = {
    "repro_torch.models.moe": {"_route": "moe.route", "_dispatch": "moe.dispatch",
                               "_expert_ffn": "moe.experts", "_combine": "moe.combine"},
    "repro_torch.train.optimizer": {"apply": "optimizer.apply"},
}
FLASH_OPS = "repro_torch.kernels.flash_attention.ops"
SCAN = 256  # host events looked back through for the one running at a gap


@contextlib.contextmanager
def labels():
    """Each function of ``LABELS`` under its ``record_function`` label."""
    from torch.profiler import record_function

    saved = []

    def labelled(fn, label):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call

    for mod_name, fns in LABELS.items():
        mod = importlib.import_module(mod_name)
        for fn_name, label in fns.items():
            saved.append((mod, fn_name, getattr(mod, fn_name)))
            setattr(mod, fn_name, labelled(getattr(mod, fn_name), label))
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


@contextlib.contextmanager
def flash_calls(calls: List[Tuple]):
    """Records each flash call's shape into ``calls`` as (kernels, B, H, Hk,
    Sq, Skv, Dh, dtype, causal, window, q_offset): the forward with lse runs
    ``flash_fwd_lse``, the backward ``flash_bwd_dq`` and ``flash_bwd_dkv``."""
    ops = importlib.import_module(FLASH_OPS)
    fwd, bwd = ops.flash_attention_fwd_lse, ops.flash_attention_bwd

    def shape(q, k, kw):
        B, H, Sq, Dh = q.shape
        return (B, H, k.shape[1], Sq, k.shape[2], Dh, str(q.dtype).replace("torch.", ""),
                kw.get("causal", True), kw.get("window"), kw.get("q_offset", 0))

    def fwd_rec(q, k, v, **kw):
        calls.append((("flash_fwd_lse",), *shape(q, k, kw)))
        return fwd(q, k, v, **kw)

    def bwd_rec(q, k, v, o, lse, do, **kw):
        calls.append((("flash_bwd_dq", "flash_bwd_dkv"), *shape(q, k, kw)))
        return bwd(q, k, v, o, lse, do, **kw)

    ops.flash_attention_fwd_lse, ops.flash_attention_bwd = fwd_rec, bwd_rec
    try:
        yield
    finally:
        ops.flash_attention_fwd_lse, ops.flash_attention_bwd = fwd, bwd


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float                          # host clock over the profiled steps
    ops: List[Tuple[str, float, float]]      # device operations: (name, start us, end us)
    label_us: Dict[str, float]               # label -> device us
    host: List[Tuple[str, float, float]]     # host events: (name, start us, end us)
    flash: List[Tuple]                       # flash_calls' records

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.intervals())

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def kernels(self) -> List[Tuple[str, float, float]]:
        """The device operations that are kernels (not copies or fills)."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def device_ops(self, n: int = 10) -> List[List[Any]]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by_name[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List[Any]]:
        """The device's idle time between operations, by the innermost host
        event running when each gap opened ("host idle" where none was)."""
        spans = self.intervals()
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_what: Dict[str, float] = defaultdict(float)
        for (_, end), (start, _) in zip(spans, spans[1:]):
            what = "host idle"
            i = bisect.bisect_right(starts, end)
            for name, _s, e in reversed(host[max(0, i - SCAN):i]):
                if e >= end:  # the latest-starting host event still running
                    what = name
                    break
            by_what[what] += (start - end) / 1e6
        return [[k, v] for k, v in sorted(by_what.items(), key=lambda kv: -kv[1])[:n]]


def profiled(step: Callable[[], None], steps: int) -> Trace:
    """``steps`` calls of ``step`` (each ending in a device sync) under the
    profiler, with the labels and the flash calls recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls: List[Tuple] = []
    torch.cuda.synchronize()
    with labels(), flash_calls(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    names = {label for fns in LABELS.values() for label in fns.values()}
    ops, host, label_us = [], [], defaultdict(float)
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type.name == "CUDA":
            if e.name not in names:
                ops.append(span)
        elif e.name in names:
            label_us[e.name] += float(e.device_time_total)
        else:
            host.append(span)
    return Trace(steps, window_s, ops, dict(label_us), host, calls)


def flash_roofline(trace: Trace) -> Optional[float]:
    """Σ of the recorded flash calls' bounds over Σ of the flash kernels'
    device time, in %; None where the trace holds none."""
    from . import counts

    bound = sum(counts.flash_bound_s(k, *shape) for kernels, *shape in trace.flash
                for k in kernels)
    spent = sum(e - s for name, s, e in trace.kernels() if "flash_fwd" in name
                or "flash_bwd" in name) / 1e6
    if not trace.flash or spent <= 0:
        return None
    return 100.0 * bound / spent
