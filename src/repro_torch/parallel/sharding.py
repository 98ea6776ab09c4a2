"""Logical-axis sharding rules on a ``DeviceMesh`` (counterpart of
``repro/parallel/sharding.py``, with ``batch_specs_tree`` and
``sanitize_specs`` of ``repro/train/train_step.py``).

Model code names the axes of every parameter and cache leaf with
*logical* names ("embed", "heads", "vocab", "fsdp", "batch", ...;
``ModelZoo.param_specs`` / ``cache_specs``).  A ``ShardingRules`` table
maps them to mesh axes: the RailX mapping puts tensor parallelism on the
intra-node 2D mesh ("model") and FSDP / data parallelism on the rail rings
("data", "pod").  A spec is a tuple with one entry per tensor dim: None
(whole), a mesh axis name, or a tuple of them (major first), as a JAX
``PartitionSpec``.

Block semantics are JAX ``NamedSharding``'s: a dim of size n split over
axes of total size k is cut into k equal blocks, and the rank at mesh
coordinate c holds block ``c[a0] * |a1| + c[a1]`` of it.  ``Layout`` holds
a tree's specs on a mesh and moves leaves between whole and local
(``Layout.shard`` gives each rank its block of every leaf of a tree;
``Layout.gather`` rebuilds the whole leaves with all-gathers, on every
rank); ``placements`` gives the same split as ``torch.distributed.tensor``
placements.

The reference's ``shard_hint``, ``use_rules`` and manual-axes machinery
(activation constraints for GSPMD to propagate) have no counterpart: the
port's layers name their collectives explicitly (``models/common.py``,
``models/transformer.py``, ``collectives/autograd.py``).  The one hint that
moves work is ``seq``: ``seq_axes`` reads which axes the rules cut the
positions over, and ``rank_batch`` gives a rank its rows of a batch and
its block of their positions (sequence parallelism,
``models/transformer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

PhysAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[PhysAxes, ...]

# logical axis -> mesh axes, for the production (data, model) mesh with an
# optional leading pod axis
DEFAULT_RULES: Dict[str, PhysAxes] = {
    # data-parallel batch: pod x rail rings (the FSDP domain shares the batch)
    "batch": ("pod", "data"),
    "ep_batch": ("pod", "data"),   # batch groups that feed EP all-to-all
    # sequence left unsharded by default (CP optional)
    "seq": None,
    "kv_seq": None,
    # tensor parallelism on the intra-node 2D mesh
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "tp_embed": "model",
    # FSDP parameter sharding over the rail (data) axis
    "fsdp": "data",
    # expert parallelism over the rail-ring all-to-all dimension
    "expert": "data",
    # never sharded
    "embed": None,
    "head_dim": None,
    "state": None,
    "stack": None,
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: Dict[str, PhysAxes]

    def spec(self, names: Sequence[Optional[str]]) -> Spec:
        """Logical names -> spec; a mesh axis is used at most once."""
        phys = []
        used = set()
        for nm in names:
            if nm is None:
                phys.append(None)
                continue
            if nm not in self.table:
                raise KeyError(f"unknown logical axis {nm!r}")
            ax = self.table[nm]
            if ax is None:
                phys.append(None)
            elif isinstance(ax, tuple):
                ax = tuple(a for a in ax if a not in used)
                used.update(ax)
                phys.append(ax if ax else None)
            elif ax in used:
                phys.append(None)
            else:
                used.add(ax)
                phys.append(ax)
        return tuple(phys)


def attention_overrides(cfg, tp: int, kind: str = "train") -> Dict[str, PhysAxes]:
    """Divisibility-aware attention mapping: heads over the TP axis when
    they divide it (KV heads replicated when they do not); otherwise
    sequence parallelism on the TP axis for train / prefill and split-KV
    (kv_seq over it) for decode, attention weights sharded over fsdp only."""
    ov: Dict[str, PhysAxes] = {}
    if cfg.family == "xlstm":
        return ov  # flat-dim projections; head dims never sharded
    if cfg.heads % tp == 0:
        if cfg.kv_heads % tp:
            ov["kv_heads"] = None
    else:
        ov["heads"] = None
        ov["kv_heads"] = None
        if kind == "decode":
            ov["kv_seq"] = "model"
        else:
            ov["seq"] = "model"
    d_ff = cfg.moe.d_ff if cfg.moe is not None else cfg.d_ff
    if d_ff and d_ff % tp:
        ov["mlp"] = None
    return ov


def make_rules(mesh_axes: Sequence[str],
               overrides: Optional[Dict[str, PhysAxes]] = None) -> ShardingRules:
    """DEFAULT_RULES restricted to the axes of the mesh (no 'pod' on a
    single-pod mesh), then ``overrides``."""
    axes = set(mesh_axes)
    table: Dict[str, PhysAxes] = {}
    for k, v in DEFAULT_RULES.items():
        if v is None:
            table[k] = None
        elif isinstance(v, tuple):
            kept = tuple(a for a in v if a in axes)
            table[k] = kept if kept else None
        else:
            table[k] = v if v in axes else None
    if overrides:
        table.update(overrides)
    return ShardingRules(table)


def _is_names(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(n, (str, type(None))) for n in x)


def logical_spec_tree(tree: Any, rules: ShardingRules) -> Any:
    """A nested dict of logical-name tuples -> the same tree of specs."""
    if _is_names(tree):
        return rules.spec(tree)
    return {k: logical_spec_tree(v, rules) for k, v in tree.items()}


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> flat ``a.b.c`` keys (the ``ParamTree`` state-dict keys)."""
    if not isinstance(tree, Mapping):
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}{k}."))
    return out


# ---------------------------------------------------------------------------
# Mesh sizes, batch specs, non-dividing dims
# ---------------------------------------------------------------------------


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` (or of such a dict, returned as is)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def entry_axes(entry: PhysAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_prod(sizes: Mapping[str, int], axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_specs_tree(mesh: Any, example: Mapping[str, Any]) -> Dict[str, Spec]:
    """Per-key batch specs: the batch dim (dim 1 of ``positions3``) over the
    DP axes; a batch dim that does not divide the DP size stays whole."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(sizes)
    dp_size = _axis_prod(sizes, dp)
    out: Dict[str, Spec] = {}
    for key, leaf in example.items():
        ndim = len(leaf.shape)
        bdim = 1 if key == "positions3" else 0
        shard = dp if leaf.shape[bdim] % max(dp_size, 1) == 0 else None
        if key == "positions3":
            out[key] = (None, shard, *([None] * (ndim - 2)))
        else:
            out[key] = (shard, *([None] * (ndim - 1)))
    return out


def seq_axes(mesh: Any, overrides: Optional[Dict[str, PhysAxes]] = None) -> Tuple[str, ...]:
    """The mesh axes of size > 1 that cut the positions of the train and
    prefill activations under the default rules and ``overrides``: the
    rules' ``seq`` entry less the axes that ``batch`` takes first, as the
    reference's ``("batch", "seq", ...)`` hints resolve (``seq -> "model"``
    from ``attention_overrides`` where the heads do not divide |model|).
    The port cuts positions over "model" only; another axis raises
    ``ValueError``."""
    sizes = axis_sizes(mesh)
    spec = make_rules(tuple(sizes), overrides).spec(("batch", "seq"))
    axes = tuple(a for a in entry_axes(spec[1]) if sizes.get(a, 1) > 1)
    if axes and axes != ("model",):
        raise ValueError(f"the rule seq -> {axes}: the port runs sequence parallelism over "
                         "'model' only")
    return axes


def cut_positions(batch: Mapping[str, Any], mesh: Any, axes: Sequence[str]) -> Dict[str, Any]:
    """Each entry's block of positions that this rank holds under sequence
    parallelism over ``axes``: S / |axes| consecutive positions from
    ``c * S / |axes|``, c the rank's coordinate over ``axes`` (major first).
    |axes| must divide every entry's positions (the reference assumes "any
    seq divides 16"); otherwise ``ValueError``."""
    if not axes:
        return dict(batch)
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n, idx = _axis_prod(sizes, axes), 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    out = {}
    for key, v in batch.items():
        d = 2 if key == "positions3" else 1  # (3, B, S); the rest (B, S, ...)
        S = v.shape[d]
        if S % n:
            raise ValueError(f"{key}: {S} positions do not split over {tuple(axes)} ({n}); "
                             f"sequence parallelism (the rule seq -> {tuple(axes)}) needs "
                             "the axes to divide the sequence")
        out[key] = v.narrow(d, idx * (S // n), S // n)
    return out


def rank_batch(mesh: Any, batch: Mapping[str, Any], specs: Optional[Mapping[str, Spec]] = None,
               seq: Sequence[str] = ()) -> Dict[str, Any]:
    """This rank's block of a batch: its rows (``block_slices`` over
    ``specs``, by default ``batch_specs_tree``) and, under sequence
    parallelism over ``seq``, its positions of them (``cut_positions``)."""
    specs = batch_specs_tree(mesh, batch) if specs is None else specs
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    rows = {k: v[block_slices(v.shape, specs[k], sizes, coord)] for k, v in batch.items()}
    return cut_positions(rows, mesh, seq)


def _shape(leaf: Any) -> Tuple[int, ...]:
    if isinstance(leaf, int):
        return ()
    return tuple(getattr(leaf, "shape", leaf))


def sanitize_specs(spec_tree: Any, shapes_tree: Any, mesh: Any) -> Any:
    """Drop the sharding of every dim its mesh axes do not divide (a
    whisper vocab of 51866 over 16; granite's single KV head stays sharded
    on its Hk * Dh dim, which divides)."""
    sizes = axis_sizes(mesh)
    if isinstance(spec_tree, Mapping):
        return {k: sanitize_specs(v, shapes_tree[k], sizes) for k, v in spec_tree.items()}
    dims = _shape(shapes_tree)
    out = []
    for i, entry in enumerate(spec_tree):
        if entry is None or i >= len(dims):
            out.append(None if i >= len(dims) else entry)
            continue
        size = _axis_prod(sizes, entry_axes(entry))
        out.append(entry if size and dims[i] % size == 0 else None)
    return tuple(out)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_slices(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int],
                 coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slices of the block that the rank at ``coord`` holds."""
    out = []
    for i, n in enumerate(shape):
        axes = entry_axes(spec[i]) if i < len(spec) else ()
        k, idx = 1, 0
        for a in axes:  # major to minor
            idx = idx * sizes[a] + coord[a]
            k *= sizes[a]
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {axes} ({k})")
        out.append(slice(idx * (n // k), (idx + 1) * (n // k)))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int]) -> Tuple[int, ...]:
    return tuple(n // _axis_prod(sizes, entry_axes(spec[i]) if i < len(spec) else ())
                 for i, n in enumerate(shape))


def placements(spec: Spec, mesh) -> tuple:
    """The spec as ``torch.distributed.tensor`` placements, one per mesh
    dim.  A dim split over several axes must name them in mesh order (the
    order in which DTensor nests them)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{axes} split one dim against the mesh order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The specs of a flat tree of leaves (``a.b.c`` keys) on ``mesh``, and
    their whole shapes."""

    mesh: Any
    specs: Dict[str, Spec]
    shapes: Dict[str, Tuple[int, ...]]

    @property
    def sizes(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    @property
    def coord(self) -> Dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))

    def key_of(self, path: str) -> Optional[str]:
        """The spec key of a leaf path (``a.b.c``, or a checkpoint path such
        as ``opt/mu/a/b/c``): its longest suffix that names a leaf."""
        parts = path.replace("/", ".").split(".")
        for i in range(len(parts)):
            key = ".".join(parts[i:])
            if key in self.specs:
                return key
        return None

    def block(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole leaf (no copy when nothing is cut)."""
        want = self.shapes.get(key)
        if want is not None and tuple(whole.shape) != tuple(want):
            raise ValueError(f"{key}: shape {tuple(whole.shape)} != {tuple(want)}")
        return whole[block_slices(whole.shape, self.specs[key], self.sizes, self.coord)]

    def whole(self, key: str, local: torch.Tensor) -> torch.Tensor:
        """All-gather a rank's block into the whole leaf, on every rank (new
        memory, also where nothing is cut)."""
        from ..collectives.schedules import all_gather_axis

        sizes = self.sizes
        out, gathered = local.detach(), False
        for dim, entry in enumerate(self.specs[key]):
            axes = tuple(a for a in entry_axes(entry) if sizes[a] > 1)
            if axes:
                out, gathered = all_gather_axis(out, self.mesh, axes, dim), True
        return out.contiguous() if gathered else out.clone(memory_format=torch.contiguous_format)

    def _map(self, tree: Any, fn) -> Any:
        from ..models.common import ParamTree

        if isinstance(tree, ParamTree):
            state = self._map(dict(tree.state_dict(keep_vars=True)), fn)
            requires_grad = any(p.requires_grad for p in tree.parameters())
            return ParamTree.from_state_dict(
                {k: v.detach() for k, v in state.items()}, requires_grad)
        return self._map_nested(tree, fn, "")

    def _map_nested(self, tree: Mapping, fn, prefix: str) -> Dict[str, Any]:
        out = {}
        for k, v in tree.items():
            key = prefix + k
            if isinstance(v, Mapping):
                out[k] = self._map_nested(v, fn, key + ".")
            else:
                out[k] = fn(key, v) if torch.is_tensor(v) and key in self.specs else v
        return out

    def shard(self, tree: Any) -> Any:
        """Whole leaves -> this rank's blocks, contiguous (a ``ParamTree``, or
        a dict, flat or nested, of ``a.b.c`` paths; leaves without a spec and
        ints pass through)."""
        return self._map(tree, lambda k, v: self.block(k, v).contiguous())

    def gather(self, tree: Any) -> Any:
        """This rank's blocks -> whole leaves; every rank must call it."""
        return self._map(tree, self.whole)


def param_layout(zoo, mesh, overrides: Optional[Dict[str, PhysAxes]] = None) -> Layout:
    """The layout of ``zoo``'s params on ``mesh`` under the default rules
    and ``overrides`` (as the reference's ``make_train_step`` /
    ``make_serve_step`` derive their param shardings from
    ``rules_overrides``)."""
    shapes = zoo.param_shapes()
    rules = make_rules(mesh.mesh_dim_names, overrides)
    specs = flatten(logical_spec_tree(zoo.param_specs(), rules))
    return Layout(mesh, sanitize_specs(specs, shapes, mesh), shapes)


def cache_layout(zoo, mesh, cache_example: Optional[Mapping[str, Any]] = None,
                 overrides: Optional[Dict[str, PhysAxes]] = None) -> Layout:
    """The layout of ``zoo``'s decode cache on ``mesh`` under the default
    rules and ``overrides``; sanitized against ``cache_example`` (whole
    shapes) when one is given, as the reference's ``make_serve_step``."""
    rules = make_rules(mesh.mesh_dim_names, overrides)
    specs = flatten(logical_spec_tree(zoo.cache_specs(), rules))
    example = flatten(cache_example) if cache_example is not None else {}
    shapes = {k: _shape(example[k]) if cache_example is not None else None for k in specs}
    if cache_example is not None:
        specs = sanitize_specs(specs, shapes, mesh)
    return Layout(mesh, specs, shapes)
