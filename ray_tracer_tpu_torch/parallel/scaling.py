"""Scaling efficiency and the work-balance prediction.

Counterpart of `ray_tracer_tpu/parallel/scaling.py`: `scaling_report`
renders the prepared scene on meshes over the first n ranks and reports
throughput and efficiency against the one-device rate; `balance_report`
splits the primary rays' traversal steps (kernel B or C) into shards,
contiguous and round-robin, and reports mean/max work a shard, the
bound on a lock-step fleet's efficiency that the round-robin balance of
`render_sharded` is there to lift.
"""

from __future__ import annotations

import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tracer_tpu_torch.parallel.mesh import in_mesh, make_mesh
from ray_tracer_tpu_torch.parallel.multihost import initialize
from ray_tracer_tpu_torch.parallel.shard import render_sharded, stride_permutation


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _shared_devices(dev: torch.device) -> bool:
    """Do two ranks of the group compute on one device (or on the host's
    CPU cores)?"""
    here = (socket.gethostname(), str(dev))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, here)
    return dev.type == "cpu" or len(set(everyone)) < len(everyone)


def scaling_report(prep, device_counts: Optional[List[int]] = None,
                   repeats: int = 3) -> Dict[str, object]:
    """Throughput against device count: for each count n a mesh over the
    first n ranks renders `repeats` frames (after one untimed) ->
    {"rays_per_frame", "rows": [{"devices", "mrays_per_s", "efficiency"}],
    and "note" where the efficiency is not hardware evidence: CPU ranks,
    or ranks that share one card}.  Every rank calls it (the meshes are
    made collectively); the rows are rank 0's, and a rank outside a count's
    mesh has no row for it."""
    initialize()
    dev = prep.device
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= world]
    cam = prep.cfg.camera
    rays = cam.width * cam.height * 2  # primary + shadow
    shared = _shared_devices(dev)
    rows = []
    base_per_device = None
    for n in device_counts:
        mesh = make_mesh(n, ("rays",), devices=dev)
        if not in_mesh(mesh):
            continue
        render_sharded(prep, mesh=mesh)  # the first frame builds and loads
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            render_sharded(prep, mesh=mesh)
        _sync(dev)
        sec = (time.perf_counter() - t0) / repeats
        mrays = rays / sec / 1e6
        if base_per_device is None:
            # per device, so that the report holds when the counts do not
            # start at 1
            base_per_device = mrays / n
        rows.append({"devices": n, "mrays_per_s": round(mrays, 4),
                     "efficiency": round((mrays / n) / base_per_device, 4)})
    out = {"rays_per_frame": rays, "rows": rows}
    if shared:
        out["note"] = ("ranks share one device (CPU cores or one card); validates the "
                       "machinery and balance, not hardware scaling")
    return out


def balance_report(prep, n_shards: int) -> Dict[str, float]:
    """Predicted lock-step scaling limit from per-shard work balance: the
    primary rays' traversal steps (kernel C on the packed grid, else
    kernel B) split into n_shards contiguously and round-robin ->
    {"n_shards", "balance_contiguous", "balance_round_robin"}, each the
    mean over the max of the shards' step sums."""
    from ray_tracer_tpu_torch.ops.camera import camera_rays
    from ray_tracer_tpu_torch.ops.traverse import traverse_grid, vertex_table
    from ray_tracer_tpu_torch.ops.traverse_packed import traverse_packed
    from ray_tracer_tpu_torch.render.metrics import traced_in_tiles

    rays = camera_rays(prep.cfg.camera, device=prep.device)
    if prep.cfg.render.traversal == "packed":
        def trace(rb):
            return traverse_packed(rb, prep.packed.arrays, prep.packed.meta, t_gate=1e-4,
                                   consts=prep.frame().consts)
    else:
        tri9 = vertex_table(*prep.scene.triangle_soa())

        def trace(rb):  # float32 dets, as the JAX function's default
            return traverse_grid(rb, prep.grid.arrays, prep.grid.meta, tri9, t_gate=1e-4,
                                 early_exit=True, tables=prep.dda)
    res = traced_in_tiles(trace, rays, max(1, prep.cfg.render.ray_tile))
    steps = res.steps.cpu().numpy().astype(np.float64)
    r = steps.shape[0]
    steps = np.concatenate([steps, np.zeros((-r) % n_shards)])

    def eff(assignment):
        shard_work = assignment.reshape(n_shards, -1).sum(axis=1)
        return float(shard_work.mean() / shard_work.max())

    contiguous = eff(steps.reshape(-1))
    strided = eff(steps[stride_permutation(steps.shape[0], n_shards)])
    return {
        "n_shards": n_shards,
        "balance_contiguous": round(contiguous, 4),
        "balance_round_robin": round(strided, 4),
    }


__all__ = ["balance_report", "scaling_report"]
