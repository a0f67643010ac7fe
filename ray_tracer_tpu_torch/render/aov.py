"""AOV (arbitrary output variable) buffers and ambient occlusion.

Counterpart of `ray_tracer_tpu/render/aov.py`: depth, hit mask, triangle
id, material id, geometric normal and hit position per pixel from one
primary trace (`render_aovs`), and an ambient-occlusion map from a fixed
Fibonacci hemisphere of any-hit occlusion rays a hit (`render_ao`).  The
traces are kernel B (csr) or kernel C (packed) on the card, one launch
each, and their plain versions on the CPU in `ray_tile` chunks.  With
`mesh=` every trace is ray-sharded over the mesh's "rays" axis
(`parallel.shard.trace_sharded`), bitwise the single-device buffers on
every rank; with `mesh=` and `ring=True` the geometry is sharded over the
mesh's "tris" axis and every trace is a ring orbit
(`parallel.shard.trace_ring`: each shard's grid march, kernel C, or the
all-pairs hop), the normals from the carried winner vertices: ids and
flags exact, floats to the traversal's arithmetic.  ring=True without a
mesh is the single-device path, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.ops.camera import camera_rays
from ray_tracer_tpu_torch.ops.traverse import traverse_grid, vertex_table
from ray_tracer_tpu_torch.ops.traverse_packed import traverse_packed
from ray_tracer_tpu_torch.render.metrics import traced_in_tiles


def _traced(prep, rays, mesh, stop_on_first_hit=False, gate=None, tri9=None):
    """(hit, t, tri_id) of `_trace`, ray-sharded over mesh's "rays" axis
    when a mesh is given."""
    if mesh is None:
        res = _trace(prep, rays, stop_on_first_hit=stop_on_first_hit, gate=gate, tri9=tri9)
        return res.hit, res.t, res.tri_id
    from ray_tracer_tpu_torch.parallel.shard import trace_sharded

    if gate is None:
        rcfg = prep.cfg.render
        gate = 0.0 if rcfg.shading == "serial" else rcfg.shadow_eps
    return trace_sharded(prep, rays, mesh, t_gate=gate, stop_first=stop_on_first_hit)


def _trace(prep, rays, stop_on_first_hit=False, gate=None, tri9=None):
    """The primary or occlusion trace the buffers share.  gate=None is the
    primary policy (serial accepts t > 0, parallel t > eps); occlusion
    rays pass eps so that a ray leaving its own triangle cannot take it
    again.  tri9: the CSR walk's vertex table, hoisted by callers that
    trace many times."""
    rcfg = prep.cfg.render
    if gate is None:
        gate = 0.0 if rcfg.shading == "serial" else rcfg.shadow_eps
    if rcfg.traversal == "packed":
        consts = prep.frame().consts

        def trace(rb):
            return traverse_packed(rb, prep.packed.arrays, prep.packed.meta, t_gate=gate,
                                   stop_on_first_hit=stop_on_first_hit, consts=consts)
    else:
        tri9 = vertex_table(*prep.scene.triangle_soa()) if tri9 is None else tri9

        def trace(rb):
            return traverse_grid(rb, prep.grid.arrays, prep.grid.meta, tri9, t_gate=gate,
                                 early_exit=True, det_dtype=rcfg.det_dtype,
                                 stop_on_first_hit=stop_on_first_hit, tables=prep.dda)
    return traced_in_tiles(trace, rays, max(1, rcfg.ray_tile))


def _face_normal(tv0, tv1, tv2, serial: bool) -> torch.Tensor:
    """The unit geometric normal of the shading convention in use
    (Serial/geometry.h:234-240, Parallel/geometry.cuh:160)."""
    if serial:
        return vm.normalize(vm.cross(tv0 - tv1, tv2 - tv0))
    return vm.normalize(vm.cross(tv2 - tv1, tv0 - tv1))


def _aov_buffers(rays, hit, t, tid, mat_ids, tv0, tv1, tv2, serial, h, w):
    """The buffers from per-ray hit data (aov.py:47-70 of the JAX package)."""
    n = _face_normal(tv0, tv1, tv2, serial)
    hit3 = hit[:, None]
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    at = rays.at(t_safe)
    pos = torch.where(hit3, at, torch.zeros_like(at))

    def img(x, ch=None):
        return x.reshape((h, w) if ch is None else (h, w, ch))

    minus1 = torch.full_like(tid, -1)
    return {
        "depth": img(torch.where(hit, t, torch.full_like(t, math.inf))),
        "hit": img(hit),
        "tri_id": img(torch.where(hit, tid, minus1)),
        "material_id": img(torch.where(hit, mat_ids.to(tid.dtype), minus1)),
        "normal": img(torch.where(hit3, n, torch.zeros_like(n)), 3),
        "position": img(pos, 3),
    }


def render_aovs(prep, mesh=None, ring: bool = False,
                ring_grids=None) -> Dict[str, torch.Tensor]:
    """-> dict of (H, W, ...) buffers on the scene's device: 'depth' (f32,
    inf on miss), 'hit' (bool), 'tri_id' (i32, -1 on miss), 'material_id'
    (i32, -1), 'normal' (f32 unit, 0 on miss), 'position' (f32, 0 on miss).
    mesh: the rays sharded over its "rays" axis, every rank getting the
    whole buffers, bitwise the single-device ones; with ring=True the
    geometry sharded by ring orbits over its "tris" axis."""
    cfg = prep.cfg
    h, w = cfg.camera.height, cfg.camera.width
    rays = camera_rays(cfg.camera, device=prep.device)
    serial = cfg.render.shading == "serial"
    if mesh is not None and ring:
        from ray_tracer_tpu_torch.parallel.shard import trace_ring

        gate = 0.0 if serial else cfg.render.shadow_eps
        b = trace_ring(prep, rays, mesh, t_gate=gate, ring_grids=ring_grids)
        return _aov_buffers(rays, b["hit"], b["t"], b["tri_id"], b["mat"], b["tv0"], b["tv1"],
                            b["tv2"], serial, h, w)
    hit, t, tid = _traced(prep, rays, mesh)
    tri = torch.clamp(tid, min=0).long()
    v0, v1, v2 = prep.scene.triangle_soa()
    return _aov_buffers(rays, hit, t, tid, prep.scene.face_material[tri],
                        v0[tri], v1[tri], v2[tri], serial, h, w)


def hemisphere_dirs(n: int) -> np.ndarray:
    """Deterministic Fibonacci point set on the +z unit hemisphere -> (n, 3)
    float32, area-uniform (z = (i+0.5)/n, golden-angle azimuth)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    z = i / n
    r = np.sqrt(1.0 - z * z)
    th = np.pi * (3.0 - np.sqrt(5.0)) * i
    return np.stack([r * np.cos(th), r * np.sin(th), z], axis=1).astype(np.float32)


def render_ao(prep, samples: int = 16, radius: float = 1.0, mesh=None, ring: bool = False,
              ring_grids=None) -> torch.Tensor:
    """Ambient-occlusion map -> (H, W) f32 in [0, 1]: for each primary hit,
    `samples` any-hit occlusion rays over the Fibonacci hemisphere about the
    eye-facing geometric normal; ao is the unoccluded share within `radius`
    (1 where the pixel misses).  Each sample is one trace of every pixel
    (misses retire at entry), gated t > eps as the renderer's shadow rays
    are, and a hit counts only at t <= radius.  mesh: every trace sharded
    over its "rays" axis, bitwise the single-device map on every rank;
    with ring=True every sample a ring occlusion orbit over the geometry
    sharded on its "tris" axis, the normals from the carried vertices."""
    cfg = prep.cfg
    rcfg = cfg.render
    h, w = cfg.camera.height, cfg.camera.width
    eps = rcfg.shadow_eps
    rays = camera_rays(cfg.camera, device=prep.device)
    serial = rcfg.shading == "serial"
    ring = mesh is not None and ring
    if ring:
        from ray_tracer_tpu_torch.parallel.shard import build_ring_shard, trace_ring

        if rcfg.traversal == "packed" and ring_grids is None:
            ring_grids = build_ring_shard(prep, mesh)  # once for every orbit
        b = trace_ring(prep, rays, mesh, t_gate=0.0 if serial else eps, ring_grids=ring_grids)
        hit, t = b["hit"], b["t"]
        n = _face_normal(b["tv0"], b["tv1"], b["tv2"], serial)
    else:
        hit, t, tid = _traced(prep, rays, mesh)
        tri = torch.clamp(tid, min=0).long()
        v0, v1, v2 = prep.scene.triangle_soa()
        n = _face_normal(v0[tri], v1[tri], v2[tri], serial)
    # face the eye, as two-sided AO does: flip normals pointing away
    n = torch.where((vm.dot(n, rays.dirn) > 0)[:, None], -n, n)

    poi = rays.at(torch.where(hit, t, torch.zeros_like(t)))
    orig = torch.where(hit[:, None], poi, torch.full_like(poi, math.inf))  # misses retire

    # a tangent frame a hit, its helper axis chosen away from n
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    a = torch.where((torch.abs(n[:, 0]) < 0.9)[:, None], ex, ey)
    t1 = vm.normalize(vm.cross(a, n))
    t2 = vm.cross(n, t1)

    tri9 = None
    if rcfg.traversal != "packed" and not ring:
        tri9 = vertex_table(*prep.scene.triangle_soa())
    occ = torch.zeros((rays.count,), dtype=torch.float32, device=prep.device)
    for d in hemisphere_dirs(samples):
        dirn = float(d[0]) * t1 + float(d[1]) * t2 + float(d[2]) * n
        srays = RayBatch.make(orig, dirn, mint=eps, maxt=radius)
        if ring:
            sb = trace_ring(prep, srays, mesh, t_gate=eps, stop_first=True,
                            ring_grids=ring_grids)
            s_hit, s_t = sb["hit"], sb["t"]
        else:
            s_hit, s_t, _ = _traced(prep, srays, mesh, stop_on_first_hit=True, gate=eps,
                                    tri9=tri9)
        occ = occ + (s_hit & (s_t <= radius) & hit).to(torch.float32)
    ao = torch.where(hit, 1.0 - vm.div_scalar(occ, float(samples)), torch.ones_like(occ))
    return ao.reshape(h, w)


__all__ = ["hemisphere_dirs", "render_ao", "render_aovs"]
