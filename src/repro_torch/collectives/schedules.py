"""The RailX collective schedules (paper §4.2) on a ``torch.distributed``
``DeviceMesh`` (counterpart of ``repro/collectives/schedules.py``).

As in the reference's ``shard_map`` bodies, every function takes and
returns the **rank-local** tensor; the mesh and the names of its axes say
which ranks take part:

  * ``intra`` axes = the node's high-bandwidth 2D-mesh (k x bandwidth);
  * ``inter`` axes = rail rings across nodes (1 x bandwidth).

``hierarchical_all_reduce`` is Eq. (8): reduce-scatter over the intra axes,
all-reduce of the 1/|intra| shard over the inter axes, all-gather over the
intra axes, so the bytes that cross the inter axes drop from V to V/|intra|
a rank.  ``flat_all_reduce`` is the baseline and ``ring_all_reduce_2d`` the
Eq. (7) form (two halves scattered over X then Y and over Y then X).

Semantics are the reference's *tiled* ones: a reduce-scatter over an axis
of size n cuts ``dim`` into n blocks and block i ends on the rank at
coordinate i of that axis; an all-gather concatenates the blocks in
coordinate order.  Over several axes they loop in the given order (the
all-gather in reverse).  A reduction runs in the tensor's own dtype, as
``psum`` does.

``byte_ledger()`` is the counterpart of the reference's HLO byte count
(``tests/test_distributed.py``): inside it, every collective of the process
records its op, its mesh axes and the bytes of its result on this rank (the
shapes that the HLO count reads).

An all-reduce over several axes at once needs one process group over their
joint ranks.  ``attach_joint_groups`` creates every such group with
``dist.new_group``, on every rank in the same order, when
``launch.mesh.make_mesh`` builds the mesh; no private ``DeviceMesh`` API is
used.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AxisNames = Union[str, Tuple[str, ...]]

# renamed in torch 2.13; the same collective under both names
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

_JOINT_GROUPS = "_railx_joint_groups"


def _axes_tuple(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: DeviceMesh, axes: AxisNames) -> int:
    """Product of the sizes of ``axes`` (1 for none)."""
    size = 1
    for a in _axes_tuple(axes):
        size *= mesh.shape[mesh.mesh_dim_names.index(a)]
    return size


# ---------------------------------------------------------------------------
# Byte ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Transfer:
    op: str                 # all_reduce | reduce_scatter | all_gather | all_to_all
    axes: Tuple[str, ...]
    nbytes: int             # the result's bytes on this rank


@dataclasses.dataclass
class ByteLedger:
    records: List[Transfer] = dataclasses.field(default_factory=list)

    def bytes(self, op: Optional[str] = None, spanning: Optional[str] = None) -> int:
        """Bytes of the records of ``op`` (any op if None) whose axes
        include ``spanning`` (any axes if None)."""
        return sum(r.nbytes for r in self.records
                   if (op is None or r.op == op) and (spanning is None or spanning in r.axes))


# open ledgers, innermost last.  Process-wide, not per thread: on the card
# the autograd engine runs a backward (and the collectives in it) on a
# thread of its own.
_LEDGERS: List[ByteLedger] = []


@contextlib.contextmanager
def byte_ledger() -> Iterator[ByteLedger]:
    """Record every collective that this process issues inside the block,
    in a backward too (the innermost ledger records)."""
    ledger = ByteLedger()
    _LEDGERS.append(ledger)
    try:
        yield ledger
    finally:
        _LEDGERS.remove(ledger)


def _record(op: str, axes: Tuple[str, ...], out: torch.Tensor) -> None:
    if _LEDGERS:
        _LEDGERS[-1].records.append(Transfer(op, axes, out.numel() * out.element_size()))


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


def attach_joint_groups(mesh: DeviceMesh) -> None:
    """Create one process group per set of >= 2 mesh axes and per
    coordinate of the other axes; keep this rank's on the mesh.  Every rank
    of the world must call this, in the same order."""
    names = mesh.mesh_dim_names
    ranks = mesh.mesh
    me = dist.get_rank()
    groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
    for k in range(2, len(names) + 1):
        for dims in itertools.combinations(range(len(names)), k):
            rest = [d for d in range(len(names)) if d not in dims]
            size = axis_size(mesh, tuple(names[d] for d in dims))
            for row in ranks.permute(*rest, *dims).reshape(-1, size).tolist():
                group = dist.new_group(row)
                if me in row:
                    groups[tuple(names[d] for d in dims)] = group
    setattr(mesh, _JOINT_GROUPS, groups)


def _group(mesh: DeviceMesh, axes: Tuple[str, ...]) -> dist.ProcessGroup:
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = tuple(a for a in mesh.mesh_dim_names if a in axes)
    groups = getattr(mesh, _JOINT_GROUPS, None)
    if groups is None:
        raise ValueError(
            f"a collective over the joint axes {axes} needs the mesh's joint "
            "process groups: build the mesh with repro_torch.launch.mesh.make_mesh")
    return groups[key]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _reduce_scatter_one(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    inp = x.movedim(dim, 0).contiguous()
    if inp.shape[0] % n:
        raise ValueError(f"dim {dim} of size {inp.shape[0]} does not split over {axis!r} ({n})")
    out = inp.new_empty((inp.shape[0] // n, *inp.shape[1:]))
    _reduce_scatter(out, inp, group=mesh.get_group(axis))
    _record("reduce_scatter", (axis,), out)
    return out.movedim(0, dim)


def _all_gather_one(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((n * inp.shape[0], *inp.shape[1:]))
    _all_gather(out, inp, group=mesh.get_group(axis))
    _record("all_gather", (axis,), out)
    return out.movedim(0, dim)


def _all_reduce_(buf: torch.Tensor, mesh: DeviceMesh, axes: Tuple[str, ...],
                 op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce a contiguous buffer of this rank's in place."""
    if axes:
        dist.all_reduce(buf, op=op, group=_group(mesh, axes))
        _record("all_reduce", axes, buf)
    return buf


def reduce_scatter_axis(x: torch.Tensor, mesh: DeviceMesh, axes: AxisNames,
                        dim: int = 0) -> torch.Tensor:
    """Reduce-scatter along (possibly several) mesh axes, tiled on ``dim``."""
    for a in _axes_tuple(axes):
        x = _reduce_scatter_one(x, mesh, a, dim)
    return x


def all_gather_axis(x: torch.Tensor, mesh: DeviceMesh, axes: AxisNames,
                    dim: int = 0) -> torch.Tensor:
    for a in reversed(_axes_tuple(axes)):
        x = _all_gather_one(x, mesh, a, dim)
    return x


def all_reduce_axis(x: torch.Tensor, mesh: DeviceMesh, axes: AxisNames,
                    op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) over the joint ranks of ``axes`` (one collective);
    ``x`` itself is left as it was."""
    return _all_reduce_(x.clone(memory_format=torch.contiguous_format), mesh, _axes_tuple(axes),
                        op)


def all_to_all_axis(x: torch.Tensor, mesh: DeviceMesh, axis: str, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """EP dispatch/combine primitive: block i of ``split_dim`` goes to
    coordinate i of ``axis``; the blocks received are concatenated along
    ``concat_dim`` in coordinate order (paper Table 4 'All-to-All' row)."""
    n = axis_size(mesh, axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split "
                         f"over {axis!r} ({n})")
    inp = torch.stack(torch.split(x, x.shape[split_dim] // n, dim=split_dim))
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=mesh.get_group(axis))
    _record("all_to_all", (axis,), out)
    return torch.cat(out.unbind(0), dim=concat_dim)


# ---------------------------------------------------------------------------
# All-reduce schedules (paper §4.2)
# ---------------------------------------------------------------------------


def flat_all_reduce(x: torch.Tensor, mesh: DeviceMesh, axes: AxisNames) -> torch.Tensor:
    """Baseline: one all-reduce over all participating axes (inter-node
    bytes ~= V a rank)."""
    return all_reduce_axis(x, mesh, axes)


def hierarchical_all_reduce(x: torch.Tensor, mesh: DeviceMesh, intra_axes: AxisNames,
                            inter_axes: AxisNames, scatter_dim: int = 0) -> torch.Tensor:
    """RailX hierarchical all-reduce (paper Eq. 8).  ``x.shape[scatter_dim]``
    must divide by the intra axes' total size; phase 2's inter-node traffic
    is V/|intra| a rank."""
    if not _axes_tuple(intra_axes):
        return all_reduce_axis(x, mesh, inter_axes)
    x = reduce_scatter_axis(x, mesh, intra_axes, dim=scatter_dim)     # k x BW domain
    x = _all_reduce_(x.contiguous(), mesh, _axes_tuple(inter_axes))   # rails
    return all_gather_axis(x, mesh, intra_axes, dim=scatter_dim)      # k x BW domain


def ring_all_reduce_2d(x: torch.Tensor, mesh: DeviceMesh, axes_xy: Tuple[str, str],
                       scatter_dim: int = 0) -> torch.Tensor:
    """2D-ring schedule (paper Eq. 7): split the data in two halves; half A
    is reduce-scattered along X then Y, half B along Y then X; then the
    mirrored all-gathers."""
    ax, ay = axes_xy
    x, pad = _pad_to_multiple(x, 2 * axis_size(mesh, (ax, ay)), scatter_dim)
    n = x.shape[scatter_dim]
    a, b = torch.split(x, n // 2, dim=scatter_dim)
    a = reduce_scatter_axis(a, mesh, (ax, ay), dim=scatter_dim)
    b = reduce_scatter_axis(b, mesh, (ay, ax), dim=scatter_dim)
    a = all_gather_axis(a, mesh, (ax, ay), dim=scatter_dim)
    b = all_gather_axis(b, mesh, (ay, ax), dim=scatter_dim)
    out = torch.cat([a, b], dim=scatter_dim)
    return out.narrow(scatter_dim, 0, n - pad) if pad else out


def hierarchical_reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, intra_axes: AxisNames,
                                inter_axes: AxisNames, dim: int = 0) -> torch.Tensor:
    """Gradient-sharding variant (FSDP): RS(intra) then RS(inter)."""
    x = reduce_scatter_axis(x, mesh, intra_axes, dim=dim)
    return reduce_scatter_axis(x, mesh, inter_axes, dim=dim)


def hierarchical_all_gather(x: torch.Tensor, mesh: DeviceMesh, intra_axes: AxisNames,
                            inter_axes: AxisNames, dim: int = 0) -> torch.Tensor:
    x = all_gather_axis(x, mesh, inter_axes, dim=dim)
    return all_gather_axis(x, mesh, intra_axes, dim=dim)


# ---------------------------------------------------------------------------
# Whole-tree gradient reduction (used by the train step)
# ---------------------------------------------------------------------------


def _pad_to_multiple(x: torch.Tensor, mult: int, dim: int) -> Tuple[torch.Tensor, int]:
    pad = (-x.shape[dim]) % mult
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return x, pad


def tree_hierarchical_all_reduce(grads: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                                 intra_axes: AxisNames,
                                 inter_axes: AxisNames) -> Dict[str, torch.Tensor]:
    """The hierarchical schedule leaf by leaf, each leaf flattened and padded
    to a multiple of the intra size (then unpadded)."""
    intra = axis_size(mesh, intra_axes)

    def red(g: torch.Tensor) -> torch.Tensor:
        flat, pad = _pad_to_multiple(g.reshape(-1), intra, 0)
        flat = hierarchical_all_reduce(flat, mesh, intra_axes, inter_axes, 0)
        return flat[: flat.shape[0] - pad].reshape(g.shape)

    return {k: red(g) for k, g in grads.items()}


def tree_flat_all_reduce(grads: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                         axes: AxisNames) -> Dict[str, torch.Tensor]:
    return {k: all_reduce_axis(g, mesh, axes) for k, g in grads.items()}


def make_all_reduce_fn(mesh: DeviceMesh, schedule: str, intra_axes: AxisNames,
                       inter_axes: AxisNames) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> all_reduce(x) over the intra and inter axes with ``schedule``
    (``flat``, ``hierarchical`` or ``ring2d``), for tests and byte
    measurement."""
    both = _axes_tuple(intra_axes) + _axes_tuple(inter_axes)
    if schedule == "hierarchical":
        return lambda x: hierarchical_all_reduce(x, mesh, intra_axes, inter_axes)
    if schedule == "flat":
        return lambda x: flat_all_reduce(x, mesh, both)
    if schedule == "ring2d":
        if len(both) != 2:
            raise ValueError(f"ring2d takes two axes, got {both}")
        return lambda x: ring_all_reduce_2d(x, mesh, (both[0], both[1]))
    raise ValueError(schedule)
