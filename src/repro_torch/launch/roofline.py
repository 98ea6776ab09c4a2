"""Roofline terms of one traced step, per rank, at H100 SXM constants
(counterpart of ``repro/launch/roofline.py``).

The reference parses the compiled HLO of its SPMD program and prices it at
TPU v5e peaks.  The port has no compiler to ask, so it counts what one rank
dispatches while it runs the step on the ``meta`` device (shapes, no data)
in a world of torch's ``"fake"`` backend (collectives that move nothing):

* FLOPs by ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies (matmuls, convolutions, sdpa; the port's
  kernels are opaque ops on the meta device: the scans are priced by their
  formulas, ``kernels/bounds.py``, and the flash kernels by the caller, as
  the reference adds their analytic FLOPs);
* HBM bytes as the inputs plus the outputs of every dispatched op that is
  not a view, with what it writes in place and does not return (the AdamW
  operators' ``Tensor(a!)`` arguments): in eager mode each op is one
  kernel, which reads its inputs and writes its outputs once;
* collective bytes by op and mesh axes from ``collectives.byte_ledger``
  (each record the bytes of the result on this rank), split into intra-node
  bytes (over "model", NVLink) and inter-node bytes (over "data" / "pod",
  one NIC a card);
* the peak of the live bytes: the storages that the step allocates, while
  any tensor still holds them (``TraceCounter``), on top of the arguments.

Where a reference field has no counterpart, it holds what the port has:
``raw_cost_analysis`` the flop counter's per-op table (FLOPs by aten op),
``trip_counts`` the layer loop's count (the model's layers, as the
reference's fallback trip count).

Constants, NVIDIA H100 SXM5 data sheet:

* ``PEAK_FLOPS`` 989e12 FLOP/s, bf16 dense tensor cores (1979 with
  sparsity), as ``kernels/bounds.py`` and ``PERF.md`` use;
* ``HBM_BW`` 3.35e12 B/s, HBM3;
* ``NVLINK_BW`` 450e9 B/s, fourth-generation NVLink's 900 GB/s a card,
  450 GB/s a direction;
* ``NIC_BW`` 50e9 B/s, one 400 Gb/s NIC a card (ConnectX-7, as in a DGX
  H100).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..collectives.schedules import byte_ledger
from ..obs import get_tracer

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NIC_BW = 50e9
INTRA_AXES = frozenset({"model"})
META = torch.device("meta")

_aten = torch.ops.aten
# allocations that write nothing: no traffic
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
               _aten.new_empty.default, _aten.new_empty_strided.default}
# ops whose meta kernels run in Python (~0.1 ms a call): their result
# shape and dtype are taken here, as the meta kernel would give them
# (contiguous), so that a step of millions of ops traces in minutes
_BINARY = {_aten.mul.Tensor, _aten.add.Tensor, _aten.sub.Tensor, _aten.div.Tensor,
           _aten.maximum.default, _aten.minimum.default}
_UNARY = {_aten.exp.default, _aten.log.default, _aten.neg.default, _aten.tanh.default,
          _aten.sigmoid.default, _aten.silu.default, _aten.sqrt.default, _aten.rsqrt.default,
          _aten.abs.default, _aten.div.Scalar, _aten.mul.Scalar, _aten.add.Scalar,
          _aten.sub.Scalar, _aten.clamp.default}
_COMPARE = {_aten.eq.Tensor, _aten.ne.Tensor, _aten.gt.Tensor, _aten.lt.Tensor,
            _aten.ge.Tensor, _aten.le.Tensor}


def _broadcast(a: tuple, b: tuple) -> Optional[tuple]:
    if a == b:
        return a
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + a, (1,) * (n - len(b)) + b
    out = []
    for x, y in zip(a, b):
        if x != y and x != 1 and y != 1:
            return None
        out.append(y if x == 1 else x)
    return tuple(out)


def _meta_result(func, args, kwargs) -> Optional[torch.Tensor]:
    """The result of one of the ops above on meta tensors, or None where
    this shortcut does not apply."""
    if func in _BINARY and len(args) == 2 and set(kwargs) <= {"alpha"}:
        a, b = args
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if (ta and a.device.type != "meta") or (tb and b.device.type != "meta") or not ta:
            return None
        if tb and a.dtype == b.dtype and a.dim() and b.dim():
            dtype = a.dtype
        else:
            dtype = torch.result_type(a, b)
        if func is _aten.div.Tensor and not dtype.is_floating_point:
            return None
        shape = _broadcast(tuple(a.shape), tuple(b.shape)) if tb else tuple(a.shape)
        return None if shape is None else torch.empty(shape, dtype=dtype, device=META)
    if len(args) == 0 or not isinstance(args[0], torch.Tensor) or args[0].device.type != "meta":
        return None
    a = args[0]
    rest = args[1:]
    if func in _UNARY and not kwargs and a.is_floating_point() and all(
            isinstance(x, (int, float)) or x is None for x in rest):
        return torch.empty(a.shape, dtype=a.dtype, device=META)
    if func in _COMPARE and len(args) == 2 and isinstance(args[1], torch.Tensor):
        shape = _broadcast(tuple(a.shape), tuple(args[1].shape))
        return None if shape is None else torch.empty(shape, dtype=torch.bool, device=META)
    if func is _aten.where.self and len(args) == 3 and not kwargs and all(
            isinstance(x, torch.Tensor) for x in args) and args[1].dtype == args[2].dtype:
        shape = _broadcast(tuple(a.shape), tuple(args[1].shape))
        shape = shape and _broadcast(shape, tuple(args[2].shape))
        return None if shape is None else torch.empty(shape, dtype=args[1].dtype, device=META)
    if func is _aten.bmm.default and isinstance(args[1], torch.Tensor) and a.dtype == args[1].dtype:
        return torch.empty((a.shape[0], a.shape[1], args[1].shape[2]), dtype=a.dtype, device=META)
    if func is _aten.select_backward.default:
        return torch.empty(tuple(args[1]), dtype=a.dtype, device=META)
    if func is _aten.sum.dim_IntList and a.is_floating_point() and set(kwargs) <= {"dtype"}:
        dims = args[1] if len(args) > 1 else None
        keep = bool(args[2]) if len(args) > 2 else False
        dims = range(a.dim()) if not dims else [d % a.dim() for d in dims]
        shape = [1 if i in dims else n for i, n in enumerate(a.shape)] if keep else \
            [n for i, n in enumerate(a.shape) if i not in dims]
        return torch.empty(shape, dtype=kwargs.get("dtype") or a.dtype, device=META)
    return None


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (tensors, and lists or
    tuples of them, one level deep, as aten ops take and give them)."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _written_in_place(func, args, kwargs, outs) -> list:
    """The tensors ``func`` writes in place (its schema's ``Tensor(a!)``
    arguments) that are not among its results ``outs``."""
    returned = {id(t) for t in outs}
    written = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(a.name)
        written += [t for t in _tensors((value,)) if id(t) not in returned]
    return written


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class TraceCounter(TorchDispatchMode):
    """Counts what the ops dispatched inside it move and allocate: the HBM
    bytes (inputs + outputs of each op that is not a view), the live bytes
    of the storages they allocate and the peak of those.  The storages of
    ``external`` tensors (the step's arguments) are not counted as
    allocated."""

    def __init__(self, external: Iterable[torch.Tensor] = (),
                 flop_formulas: Optional[Dict[Any, Callable]] = None):
        from torch.utils.flop_counter import flop_registry, shape_wrapper

        super().__init__()
        self.ops = 0
        self.flops = 0.0
        self.flop_table: Dict[str, float] = {}
        self._formulas = {**flop_registry,
                          **{k: shape_wrapper(v) for k, v in (flop_formulas or {}).items()}}
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._external = {storage_key(t) for t in external}
        self._storages: Dict[int, List[int]] = {}   # key -> [nbytes, live tensors]

    def _drop(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _track(self, t: torch.Tensor) -> None:
        key = storage_key(t)
        if key in self._external:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = self._formulas.get(func._overloadpacket) or self._formulas.get(func)
        if formula is None:
            # a composite op reaches the mode whole under inference mode:
            # count its pieces, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = _meta_result(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        self.ops += 1
        if formula is not None:
            n = float(formula(*args, **kwargs, out_val=out))
            self.flops += n
            name = str(func._overloadpacket)
            self.flop_table[name] = self.flop_table.get(name, 0.0) + n
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not func.is_view and func not in _NO_TRAFFIC:
            ins = _tensors(args) + _tensors(kwargs.values())
            written = outs + _written_in_place(func, args, kwargs, outs)
            self.hbm_bytes += sum(_nbytes(t) for t in ins + written)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class TraceStats:
    """One rank's count of a traced step."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    intra_collective_bytes: float = 0.0   # over "model" (NVLink)
    inter_collective_bytes: float = 0.0   # over "data" / "pod" (NICs)
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)   # by op
    collective_detail: Dict[str, float] = dataclasses.field(default_factory=dict)  # "op@axes"
    flop_table: Dict[str, float] = dataclasses.field(default_factory=dict)    # by aten op
    peak_bytes: int = 0          # allocated inside the step, at its peak
    ops: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _scan_flops() -> Dict[Any, Callable]:
    """FLOP formulas of the scans' meta ops (``kernels/bounds.py``)."""
    from ..kernels import bounds
    from ..kernels.mlstm.ops import _meta_op as mlstm_op
    from ..kernels.ssd.ops import _meta_op as ssd_op

    def ssd(x, dt, Bm, Cm, A, chunk, out_shape=None, **kw):
        B, S, H, P = x
        return int(bounds.ssd_flops(B, S, H, P, Bm[-1], min(chunk, S)))

    def mlstm(q, k, v, i_gate, logf, chunk, out_shape=None, **kw):
        B, S, H, D = q
        return int(bounds.mlstm_flops(B, S, H, D, min(chunk, S)))

    return {ssd_op(): ssd, mlstm_op(): mlstm}


def trace(fn: Callable, *args, external: Iterable[torch.Tensor] = (),
          sizes: Optional[Dict[str, int]] = None) -> Tuple[Any, TraceStats]:
    """Run ``fn(*args)`` (on meta tensors, in a fake world) and count it,
    inside a ``roofline.parse`` span while tracing.  With the mesh's axis
    ``sizes``, a collective over axes of size 1 (a group of one, which
    moves nothing) is left out of the collective bytes."""
    trc = get_tracer()
    if not trc.enabled:
        return _trace(fn, args, external, sizes or {})
    with trc.span("roofline.parse", cat="launch") as sp:
        out, stats = _trace(fn, args, external, sizes or {})
        sp.set(ops=stats.ops)
    return out, stats


def _trace(fn: Callable, args: tuple, external, sizes) -> Tuple[Any, TraceStats]:
    counter = TraceCounter(external, _scan_flops())
    with byte_ledger() as ledger, counter:
        out = fn(*args)
    stats = TraceStats(flops=counter.flops, hbm_bytes=counter.hbm_bytes,
                       peak_bytes=counter.peak, ops=counter.ops,
                       flop_table=dict(counter.flop_table))
    for r in ledger.records:
        if all(sizes.get(a, 2) == 1 for a in r.axes):
            continue
        stats.collective_bytes += r.nbytes
        stats.collectives[r.op] = stats.collectives.get(r.op, 0.0) + r.nbytes
        key = f"{r.op}@{','.join(r.axes)}"
        stats.collective_detail[key] = stats.collective_detail.get(key, 0.0) + r.nbytes
        if set(r.axes) <= INTRA_AXES:
            stats.intra_collective_bytes += r.nbytes
        else:
            stats.inter_collective_bytes += r.nbytes
    return out, stats


# ---------------------------------------------------------------------------
# Roofline assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_dev: float        # the traced FLOPs (the reference's HLO count)
    hbm_bytes_per_dev: float
    collective_bytes_per_dev: float
    intra_collective_bytes_per_dev: float
    inter_collective_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_dev: float
    raw_cost_analysis: Dict[str, float]   # FLOPs by aten op (flop counter)
    memory_stats: Dict[str, float]
    collectives: Dict[str, float]
    trip_counts: Dict[str, int]           # the layer loop's count

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        if self.hlo_flops_per_dev <= 0:
            return 0.0
        return self.model_flops_per_dev / self.hlo_flops_per_dev

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the step would achieve if perfectly overlapped:
        useful-model-FLOP time / max(all three terms)."""
        bound = max(self.compute_s, self.memory_s, self.collective_s, 1e-30)
        return (self.model_flops_per_dev / PEAK_FLOPS) / bound

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["useful_flop_ratio"] = self.useful_flop_ratio
        d["roofline_fraction"] = self.roofline_fraction
        return d


def build_report(
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    stats: TraceStats,
    memory_stats: Dict[str, float],
    model_flops_global: float,
    default_trip: int = 1,
    extra_flops_global: float = 0.0,
) -> RooflineReport:
    """``stats``: one rank's count (``trace``), where the reference takes
    the HLO text and its cost analysis.  ``extra_flops_global``: FLOPs
    inside opaque kernels (the flash kernels) added analytically, per rank
    as the global count over ``chips``, as the reference does."""
    flops = stats.flops + extra_flops_global / chips
    coll_s = stats.inter_collective_bytes / NIC_BW + stats.intra_collective_bytes / NVLINK_BW
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops_per_dev=flops,
        hbm_bytes_per_dev=stats.hbm_bytes,
        collective_bytes_per_dev=stats.collective_bytes,
        intra_collective_bytes_per_dev=stats.intra_collective_bytes,
        inter_collective_bytes_per_dev=stats.inter_collective_bytes,
        compute_s=flops / PEAK_FLOPS,
        memory_s=stats.hbm_bytes / HBM_BW,
        collective_s=coll_s,
        model_flops_per_dev=model_flops_global / chips,
        raw_cost_analysis=dict(stats.flop_table),
        memory_stats=memory_stats,
        collectives=dict(stats.collective_detail),
        trip_counts={"layers": default_trip},
    )


def model_train_flops(param_count: float, tokens: float) -> float:
    """6 N D (fwd 2ND + bwd 4ND)."""
    return 6.0 * param_count * tokens


def model_decode_flops(param_count: float, tokens: float) -> float:
    """2 N per generated token (forward only)."""
    return 2.0 * param_count * tokens
