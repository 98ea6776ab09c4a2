"""Carry weights and caches between the JAX reference and the port.

The JAX package keeps params as nested dicts of arrays.  Given that tree as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``),
``params_from_jax`` returns a flat state dict whose keys are the tree paths
joined by ``.`` (``layers.attn.wq.w``, ``embed.table``): exactly the keys of
``models.common.ParamTree.state_dict()``.  Layouts cross unchanged: linear
weights stay ``(in, out)`` and stacked layers keep their leading ``L`` dim.

``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``, so bf16 crosses as
float32 (exact) and is cast on the torch side: to the ``dtype`` asked for,
or, with ``dtype=None``, back to each leaf's own dtype (a hybrid cache holds
a bf16 conv state beside an f32 SSM state).  A 0-d integer array (a cache's
``index``) becomes a Python int, as the port keeps it on the host.

``params_to_jax`` goes the other way: a state dict to the nested dict of
numpy arrays that ``jax.tree_util.tree_map(jnp.asarray, ...)`` turns into
the reference's tree.  bf16 leaves cross as float32 (exact) again.

On a mesh, ``layout=`` (``parallel.sharding.Layout``) gives each rank its
block of every leaf (``params_from_jax``) or gathers the blocks back into
whole leaves first (``params_to_jax``; every rank must call it).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .parallel.sharding import Layout

# names of the jnp dtypes used in ModelConfig / the param trees
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def torch_dtype(dtype: Any) -> torch.dtype:
    """Map a jnp/numpy dtype, or its name, to the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise KeyError(f"no torch counterpart for dtype {name!r}")
    return _DTYPES[name]


def _to_tensor(arr: Any, dtype: Optional[torch.dtype], device: Union[str, torch.device]):
    a = np.asarray(arr)
    if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
        return int(a)
    own = a.dtype.name
    if own == "bfloat16":
        a = a.astype(np.float32)
    # np.asarray of a jax.Array is read-only; from_numpy needs its own buffer
    t = torch.from_numpy(np.array(a, copy=True))
    if t.is_floating_point():
        t = t.to(dtype or torch_dtype(own))
    return t.to(device)


def params_from_jax(
    np_tree: Mapping[str, Any], *, dtype: Any, device: Union[str, torch.device],
    layout: Optional[Layout] = None,
) -> Dict[str, Any]:
    """Flatten a JAX param (or cache) pytree of numpy arrays into a state
    dict on ``device``; floating leaves are cast to ``dtype``, or keep their
    own dtype when ``dtype`` is None.  With ``layout``, this rank's blocks."""
    tdtype = None if dtype is None else torch_dtype(dtype)
    out: Dict[str, Any] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(f"{prefix}{key}.", child)
        else:
            out[prefix[:-1]] = _to_tensor(node, tdtype, device)

    walk("", np_tree)
    return out if layout is None else layout.shard(out)


def params_to_jax(state: Mapping[str, Any], layout: Optional[Layout] = None) -> Dict[str, Any]:
    """Nest a flat ``a.b.c`` state dict into ``{"a": {"b": {"c": ndarray}}}``
    on the host; bf16 becomes float32, ints stay ints.  With ``layout``, the
    state is a rank's blocks, gathered first."""
    if layout is not None:
        state = layout.gather(dict(state))
    out: Dict[str, Any] = {}
    for path, value in state.items():
        node = out
        *parents, leaf = path.split(".")
        for name in parents:
            node = node.setdefault(name, {})
        if torch.is_tensor(value):
            t = value.detach().cpu()
            value = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        node[leaf] = value
    return out
