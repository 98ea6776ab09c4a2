"""Atomic checkpoints in the reference's on-disk layout (counterpart of
``repro/checkpoint/checkpoint.py``), so that either package restores what
the other saved.

Layout:  <dir>/step_<N:08d>/
           manifest.json      {"step", "leaves": {path: {file, shape, dtype}}, "extra"}
           <path with / as __>.npy[.zst]   np.save bytes, zstd-compressed when
                                          ``zstandard`` imports (as the reference)
         <dir>/LATEST         name of the newest step dir, replaced atomically

Leaf paths are the reference's: tree keys joined by ``/``.  The port's tree
is ``{"params": ParamTree or flat state dict, "opt": AdamWState}``, whose
paths are ``params/layers/attn/wq/w``, ``opt/step``, ``opt/mu/...`` and
``opt/nu/...``, exactly those of the reference's ``{"params": <param
pytree>, "opt": AdamWState}``.  ``opt/step`` is a 0-d int32.

bf16 leaves are stored as the reference stores them: ``np.asarray`` of a
bf16 ``jax.Array`` has the ``ml_dtypes`` bfloat16 dtype, which ``np.save``
writes as raw 2-byte records (header descr ``<V2``) with the manifest dtype
``"bfloat16"``.  The port writes the same bytes (numpy alone would write
``|V2``, so it writes that header itself) and reads such a leaf back as
bf16.  (The reference's own ``restore`` cannot read it back: ``jnp.asarray``
refuses the ``V2`` records.)

A sharded run (``gspmd_fsdp``) saves and restores with ``layout=`` (the
params' ``parallel.sharding.Layout``; the AdamW moments share it): ``save``
gathers every leaf whole, leaf by leaf, on every rank (a collective: every
rank calls it), rank 0 writes, and all ranks wait for the write; the files
are the one-process layout, so either package restores them onto any mesh.
``restore`` reads whole leaves and keeps this rank's block of each.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import ParamTree
from ..parallel.sharding import Layout
from ..train.optimizer import AdamWState

try:
    import zstandard as zstd
except Exception:  # pragma: no cover
    zstd = None


def _leaf_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """path -> leaf (tensor or int), in the reference's key order."""
    if isinstance(tree, ParamTree):
        tree = {k.replace(".", "/"): v for k, v in tree.state_dict().items()}
    if isinstance(tree, AdamWState):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        out: Dict[str, Any] = {}
        for key in sorted(tree):
            out.update(_leaf_paths(tree[key], f"{prefix}{str(key).replace('.', '/')}/"))
        return out
    return {prefix[:-1]: tree}


def _npy_bytes(leaf: Any) -> Tuple[bytes, list, str]:
    """(np.save bytes, shape, manifest dtype) of a tensor or int leaf."""
    buf = io.BytesIO()
    if isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            shape = tuple(t.shape)
            np.lib.format.write_array_header_1_0(
                buf, {"descr": "<V2", "fortran_order": False, "shape": shape})
            buf.write(t.contiguous().view(torch.int16).numpy().tobytes())
            return buf.getvalue(), list(shape), "bfloat16"
        arr = t.numpy()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue(), list(arr.shape), str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def is_writer(layout: Optional[Layout]) -> bool:
    """Whether this process writes a checkpoint: always without a layout,
    rank 0 with one."""
    return layout is None or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None,
         layout: Optional[Layout] = None) -> str:
    """Atomic: write into a temp dir, rename it, then update LATEST.  With
    ``layout``, every rank calls it (see the module docstring)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    writer = is_writer(layout)
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {}}
    comp = zstd.ZstdCompressor(level=3) if zstd else None
    for key, leaf in _leaf_paths(tree).items():
        if layout is not None and torch.is_tensor(leaf) and layout.key_of(key):
            leaf = layout.whole(layout.key_of(key), leaf)
        if not writer:
            continue
        data, shape, dtype_name = _npy_bytes(leaf)
        fname = key.replace("/", "__") + ".npy" + (".zst" if comp else "")
        if comp:
            data = comp.compress(data)
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(data)
        manifest["leaves"][key] = {"file": fname, "shape": shape, "dtype": dtype_name}
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(ckpt_dir, ".LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(ckpt_dir, ".LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    if layout is not None:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def _rebuild(like: Any, leaves: Dict[str, Any], layout: Optional[Layout],
             prefix: str = "") -> Any:
    """``like`` with every leaf replaced by the loaded one of its path (with
    ``layout``, this rank's block of it)."""
    if isinstance(like, ParamTree):
        state = {k: _rebuild(v, leaves, layout, f"{prefix}{k.replace('.', '/')}/")
                 for k, v in like.state_dict().items()}
        requires_grad = any(p.requires_grad for p in like.parameters())
        return ParamTree.from_state_dict(state, requires_grad)
    if isinstance(like, AdamWState):
        return AdamWState(**{k: _rebuild(getattr(like, k), leaves, layout, f"{prefix}{k}/")
                             for k in like._fields})
    if isinstance(like, Mapping):
        return {k: _rebuild(v, leaves, layout, f"{prefix}{str(k).replace('.', '/')}/")
                for k, v in like.items()}
    key = prefix[:-1]
    if key not in leaves:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr, dtype_name = leaves[key]
    if isinstance(like, int):
        if arr.shape != ():
            raise ValueError(f"{key}: shape {arr.shape} != expected ()")
        return int(arr)
    t = _from_numpy(arr, dtype_name)
    if layout is not None and layout.key_of(key):
        t = layout.block(layout.key_of(key), t)
    if list(t.shape) != list(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(like.shape)}")
    return t.to(dtype=like.dtype, device=like.device)


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            layout: Optional[Layout] = None) -> Tuple[Any, Dict[str, Any]]:
    """Load into the structure of ``tree_like`` (tensors give shape, dtype
    and device; an int leaf stays an int).  With ``layout``, ``tree_like``
    holds this rank's blocks and each gets its block of the whole leaf.
    Returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dec = zstd.ZstdDecompressor() if zstd else None
    leaves = {}
    for key, meta in manifest["leaves"].items():
        with open(os.path.join(d, meta["file"]), "rb") as f:
            data = f.read()
        if meta["file"].endswith(".zst"):
            if dec is None:
                raise RuntimeError(f"{meta['file']} is zstd-compressed and zstandard is missing")
            data = dec.decompress(data)
        leaves[key] = (np.load(io.BytesIO(data), allow_pickle=False), meta["dtype"])
    return _rebuild(tree_like, leaves, layout), manifest["extra"]
