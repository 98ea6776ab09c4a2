"""Mesh construction on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

The single-pod mesh (16, 16) = ("data", "model") models one RailX
row-block: "model" = the 4x4-chip node 2D-mesh (TP domain, k x bandwidth),
"data" = 16 nodes joined by rail rings (the DP domain).  The multi-pod mesh
(2, 16, 16) adds the "pod" axis = two RailX blocks joined by a
dimension-split rail group (the slow DP domain).

A mesh is a ``DeviceMesh`` over the whole world, rank r at the mesh
coordinate ``unravel(r, shape)``.  ``device="cuda"`` (the default) means
NCCL, one rank per card; ``"cpu"`` means gloo.  The process group is the
caller's (``torchrun``, ``spawn_cpu_world``, or its own
``init_process_group``); a mesh never moves from the card to gloo or to the
CPU: a missing card, NCCL or process group raises.  A world of torch's
``"fake"`` backend (one process tracing one rank of a large world, the dry
run's) takes a CPU mesh: its collectives move nothing.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import device as _device
from ..collectives.schedules import attach_joint_groups


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: _device.DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    world, with the joint process groups the multi-axis collectives use."""
    dev = _device.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("a cuda mesh needs NCCL, and this torch has none")
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: run under torchrun, in spawn_cpu_world, or call "
            f"torch.distributed.init_process_group({backend!r}, ...) first")
    if backend not in dist.get_backend() and dist.get_backend() != "fake":
        raise RuntimeError(f"the process group runs {dist.get_backend()!r}; a {dev.type} mesh "
                           f"needs {backend!r}")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} has {n} ranks, the world {dist.get_world_size()}")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank() % torch.cuda.device_count())))
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    attach_joint_groups(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: _device.DeviceLike = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def railx_mesh_from_plan(plan: Any) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Translate a mapping plan's dimension split (anything with
    ``.specs[i].scale`` and ``.name``, as ``repro.core.mapping.MappingResult``)
    into a mesh signature (sizes, names)."""
    sizes = []
    names = []
    for spec in plan.specs:
        if spec.scale > 1:
            sizes.append(spec.scale)
            names.append(spec.name)
    return tuple(sizes), tuple(names)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a local world's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, args: tuple) -> None:
    torch.set_num_threads(1)  # the ranks share the host's cores
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, devices: int, device: _device.DeviceLike, *args: Any) -> None:
    """Run ``fn(rank, world, *args)`` on every rank of a world, as the port's
    examples do: ``devices`` > 0 spawns that many local gloo ranks on the CPU
    (``spawn_cpu_world``; ``device`` must be ``"cpu"``); else, under
    ``torchrun`` (``RANK`` set), this process is its rank (NCCL on the card,
    gloo on the CPU); else this process is a world of one, on a free local
    port.  The process group is destroyed when ``fn`` returns or raises."""
    if devices:
        if torch.device(device or "cuda").type != "cpu":
            raise SystemExit("--devices spawns gloo ranks on the CPU: pass --device cpu, "
                             "or run one rank per card under torchrun")
        spawn_cpu_world(fn, devices, *args)
        return
    dev = _device.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                                world_size=1)
    try:
        fn(dist.get_rank(), dist.get_world_size(), *args)
    finally:
        dist.destroy_process_group()


def spawn_cpu_world(fn: Callable, world: int, *args: Any) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` local processes joined
    by gloo on the CPU (the counterpart of the reference's forced host
    device count).  ``fn`` must be importable by name (a module-level
    function).  Raises if any rank raises.  The caller hosts the ranks'
    store on a port the system picks, so concurrent worlds cannot collide."""
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False)
    mp.start_processes(_rank_main, args=(fn, world, store.port, args), nprocs=world,
                       join=True, start_method="spawn")
