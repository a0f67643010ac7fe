"""Process groups and cross-rank data movement.

Counterpart of `ray_tracer_tpu/parallel/multihost.py` on
`torch.distributed`: one process a device, every process running the
same program (SPMD as PyTorch does it).  `initialize()` forms the process
group, `global_mesh` spans every rank, and the sharded renderers
(`parallel/shard.py`) run unchanged on one host or many, the collectives
riding NCCL between cards or gloo between CPU ranks.

One process without a group formed elsewhere is the degenerate case:
`initialize()` then forms a one-rank group on a local store, and every
helper works there.  `shutdown()` leaves the group, as
`jax.distributed.shutdown` does at exit.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tracer_tpu_torch.utils.log import get_logger, process_index

_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout: float = 300.0) -> None:
    """Form the process group (idempotent).

    With explicit arguments (coordinator_address "host:port" or a URL such
    as "tcp://host:port" or "file:///path", num_processes, process_id), or
    with torchrun's WORLD_SIZE / RANK / MASTER_ADDR set, every process
    joins that group, and a failure raises: a caller that asked for a group
    must not have each process render the whole frame alone.  With
    neither, a one-rank group forms on a local store (single-process
    mode).  backend: as given, else "nccl" where there is a card (the
    ranks run on cuda unless asked otherwise) and "gloo" without one (CPU
    ranks).  timeout (seconds)
    bounds the join and every collective after it."""
    if dist.is_initialized():
        return
    from ray_tracer_tpu_torch.parallel.mesh import forget_meshes

    forget_meshes()  # meshes of an earlier, destroyed group
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    limit = datetime.timedelta(seconds=timeout)
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("an explicit group needs coordinator_address, num_processes "
                             "and process_id")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                rank=int(process_id), timeout=limit)
    elif all(k in os.environ for k in _ENV):
        dist.init_process_group(backend, init_method="env://", timeout=limit)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=limit)
        get_logger(__name__).info("single-process mode (%s)", backend)


def shutdown() -> None:
    """Leave the process group (a no-op without one), the counterpart of
    `jax.distributed.shutdown`: a barrier, bounded by the group's timeout,
    so that no rank tears the group down under another; then the group
    destroyed, its sub-groups with it, and the kept meshes dropped.  A
    DeviceMesh holds its process groups, so until the meshes go each gloo
    group keeps its worker and transport threads running past
    `destroy_process_group`, to be torn down at interpreter exit; dropped
    here, the groups' threads are joined before this returns.

    Called from a `finally` while the rank's work raises, it skips the
    barrier and leaves at once: its peers may be waiting in a collective
    it will never join, and the failure is to show as this rank's."""
    if not dist.is_initialized():
        return
    from ray_tracer_tpu_torch.parallel.mesh import forget_meshes

    try:
        if dist.get_world_size() > 1 and sys.exc_info()[1] is None:
            dist.barrier()
    finally:
        dist.destroy_process_group()
        forget_meshes()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_host0() -> bool:
    return process_index() == 0


def global_mesh(axis_names: Tuple[str, ...] = ("rays",), shape: Optional[Sequence[int]] = None,
                devices=None):
    """Mesh over every rank, rank-major, so that the "rays" axis crosses
    hosts only at host boundaries when the ranks are numbered host by
    host (as torchrun numbers them)."""
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    initialize()
    return make_mesh(None, axis_names, shape=shape, devices=devices)


def host_tile_bounds(total_rays: int) -> Tuple[int, int]:
    """This rank's contiguous slice of the flat ray index space, as the
    shard layer deals it: rays padded to a multiple of the device count
    and dealt in equal chunks, one device a rank.  Describes the
    balance=False (unpermuted) layout; render_sharded's round-robin
    balance interleaves pixels over the shards."""
    n_dev = process_count()
    chunk = -(-total_rays // n_dev)
    lo = min(process_index() * chunk, total_rays)
    hi = min(lo + chunk, total_rays)
    return lo, hi


def _map(fn, tree):
    """fn over the tensor and numpy leaves of a NamedTuple / tuple / list /
    dict tree; other leaves pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def broadcast_scene_host0(scene):
    """Every rank gets rank 0's tensors of `scene` (any NamedTuple / tuple
    / list / dict tree of tensors and numpy arrays, the same shapes on
    every rank); the argument itself at world size 1."""
    if process_count() == 1:
        return scene
    from ray_tracer_tpu_torch.parallel.collectives import broadcast

    def one(x):
        if isinstance(x, np.ndarray):
            return broadcast(torch.from_numpy(np.ascontiguousarray(x))).numpy()
        return broadcast(x)

    return _map(one, scene)


def gather_image_host0(img) -> Optional[np.ndarray]:
    """The full image as host numpy (H, W, 3) on rank 0, None on the other
    ranks.  `render_sharded` returns the whole image on every rank (as the
    JAX package's global array), so this is a pull to the host."""
    if not is_host0():
        return None
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def write_ppm_host0(path: str, img) -> bool:
    """Write the sharded render's PPM on rank 0 (the reference's
    framebuffer write, Serial/raytracer.cpp:178-185).  Returns True on the
    writing rank."""
    from ray_tracer_tpu_torch.io.ppm import write_ppm

    full = gather_image_host0(img)
    if full is None:
        return False
    write_ppm(path, full)
    return True


__all__ = [
    "broadcast_scene_host0", "gather_image_host0", "global_mesh",
    "host_tile_bounds", "initialize", "is_host0", "process_count", "process_index",
    "shutdown", "write_ppm_host0",
]
