"""Device meshes over the ranks of the process group.

Counterpart of `ray_tracer_tpu/parallel/mesh.py`: a
`torch.distributed.device_mesh.DeviceMesh` with named axes,

  * "rays" — data parallelism over pixels and rays;
  * "tris" — triangles sharded over the axis, nearest hits min-reduced
    across it (`parallel/shard.intersect_brute_sharded`) or found by ray
    bundles orbiting it (the ring: `parallel/shard.render_sharded_geometry`).

A rank is one process and one device: `devices=` names this rank's,
else rank i takes cuda:{LOCAL_RANK} (or cuda:{rank mod the card count}),
and "cpu" puts the rank on the CPU.  Meshes are made collectively (every rank calls
`make_mesh` with the same arguments) and kept, so that a renderer that
makes its mesh each frame forms its process groups once.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tracer_tpu_torch.device import resolve_device

_MESHES = {}  # (n, axes, shape, device) -> DeviceMesh of the current group


def forget_meshes() -> None:
    """Drop the kept meshes (their groups belong to a destroyed process
    group; `multihost.shutdown` calls this after destroying it, and
    `multihost.initialize` before forming a new one)."""
    _MESHES.clear()


def _rank_device(devices) -> torch.device:
    """This rank's device: devices as given (one device, or a sequence
    with an entry a rank), else cuda:{LOCAL_RANK}."""
    rank = dist.get_rank()
    if devices is None:
        if not torch.cuda.is_available():
            return resolve_device(None)  # raises: no card, and no CPU asked for
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else rank % torch.cuda.device_count()
        return resolve_device(f"cuda:{index}")
    if isinstance(devices, (str, torch.device)):
        return resolve_device(devices)
    devices = list(devices)
    if rank >= len(devices):
        raise ValueError(f"devices names {len(devices)} ranks; this is rank {rank}")
    return resolve_device(devices[rank])


def make_mesh(n_devices: Optional[int] = None, axis_names: Tuple[str, ...] = ("rays",),
              shape: Optional[Sequence[int]] = None, devices=None) -> DeviceMesh:
    """A mesh over the first `n_devices` ranks (every rank by default).

    With one axis, all ranks go to it.  With two axes and no explicit
    shape, "tris" gets 1 (replicated geometry) and "rays" everything.
    A shape that does not match the ranks raises ValueError.  Forms a
    one-rank group first when none is formed (`multihost.initialize`)."""
    from ray_tracer_tpu_torch.parallel.multihost import initialize

    initialize()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices over {world} ranks")
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(x) for x in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices on axes {axis_names}")
    dev = _rank_device(devices)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (n, axis_names, shape, str(dev))
    mesh = _MESHES.get(key)
    if mesh is None:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axis_names)
        _MESHES[key] = mesh
    return mesh


def in_mesh(mesh: DeviceMesh) -> bool:
    """Is this rank one of the mesh's?"""
    return mesh.get_coordinate() is not None


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along `axis` (lax.axis_index)."""
    return mesh.get_local_rank(axis)


def factor_mesh(n: int) -> Tuple[int, int]:
    """Split n devices into (rays, tris) axes: largest tris factor <= sqrt(n)."""
    best = 1
    for t in range(1, int(np.sqrt(n)) + 1):
        if n % t == 0:
            best = t
    return n // best, best


__all__ = ["axis_index", "axis_size", "factor_mesh", "forget_meshes", "in_mesh", "make_mesh"]
