"""Single-pixel debug hook.

Counterpart of `ray_tracer_tpu/render/debug.py` on one device: the
reference hard-wires a debug thread for one pixel whose slab test prints
the ray's state (Parallel/raytracer.cu:367, Parallel/geometry.cuh:237-255);
`trace_pixel` traces any pixel through every stage instead (the camera
ray, the grid's box, the traversal's record, the hit geometry and the
shadow query) with the renderer's own functions on a one-ray batch, and
returns the intermediates as a dict of Python values.  The traces are
kernel B or C on the card and their plain versions on the CPU.  With
`mesh=` the primary and shadow queries are ring orbits over the geometry
sharded on the mesh's "tris" axis (`parallel.shard.trace_ring`, every
rank calling with the same arguments), the JAX function's ring mode: the
ring records no step count ("steps" is -1), and every other field is the
single-device trace's (ids exactly, floats to the traversal's
arithmetic).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ray_tracer_tpu_torch.core.aabb import AABB, slab_intersect
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.ops.camera import camera_rays
from ray_tracer_tpu_torch.ops.traverse import traverse_grid, vertex_table
from ray_tracer_tpu_torch.ops.traverse_packed import traverse_packed


class _RingRecord(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    tri_id: torch.Tensor
    steps: torch.Tensor


def trace_pixel(prep, x: int, y: int, mesh=None, ring_grids=None) -> Dict[str, Any]:
    """Diagnostic trace of pixel (x, y): camera ray, grid entry, traversal
    record, hit geometry, shadow query and shading inputs, with the gates
    and mints of the renderer's policy (RenderConfig's methods); mesh:
    through ring orbits over its "tris" axis (this rank's ring grid built
    when ring_grids is not given)."""
    cfg = prep.cfg
    rcfg = cfg.render
    # refuse the configs whose shading this trace would misreport
    if rcfg.normal_mode != "face":
        raise NotImplementedError("trace_pixel reports the face-normal pipeline only")
    if rcfg.shadow_samples > 1 and rcfg.light_radius > 0:
        raise NotImplementedError("trace_pixel reports a single point-light shadow ray only")
    dev = prep.device
    all_rays = camera_rays(cfg.camera, device=dev)
    idx = y * cfg.camera.width + x
    ray = all_rays.slice(idx, idx + 1)

    packed = rcfg.traversal == "packed"
    garr = prep.packed.arrays if packed else prep.grid.arrays
    slab_hit, t0, t1 = slab_intersect(AABB(garr.lower, garr.upper), ray)

    serial = rcfg.serial_shading
    primary_gate = rcfg.primary_gate()
    tri9 = None
    if mesh is not None:
        from ray_tracer_tpu_torch.parallel.shard import build_ring_shard, trace_ring

        if packed and ring_grids is None:
            ring_grids = build_ring_shard(prep, mesh)  # once for both orbits
        b = trace_ring(prep, ray, mesh, t_gate=0.0 if primary_gate is None else primary_gate,
                       ring_grids=ring_grids)
        res = _RingRecord(hit=b["hit"], t=b["t"], tri_id=b["tri_id"],
                          steps=torch.full((1,), -1, dtype=torch.int32))
    elif packed:
        consts = prep.frame().consts
        res = traverse_packed(ray, prep.packed.arrays, prep.packed.meta,
                              t_gate=0.0 if primary_gate is None else primary_gate,
                              consts=consts)
    else:
        tri9 = vertex_table(*prep.scene.triangle_soa())
        res = traverse_grid(ray, prep.grid.arrays, prep.grid.meta, tri9, t_gate=primary_gate,
                            early_exit=not rcfg.faithful, det_dtype=rcfg.det_dtype,
                            tables=prep.dda)

    def first(v):
        return v.cpu().numpy()[0]

    out: Dict[str, Any] = {
        "pixel": (x, y),
        "ray_origin": first(ray.orig).tolist(),
        "ray_dir": first(ray.dirn).tolist(),
        "grid_bounds": (garr.lower.cpu().numpy().tolist(), garr.upper.cpu().numpy().tolist()),
        "slab_hit": bool(first(slab_hit)),
        "slab_t0": float(first(t0)),
        "slab_t1": float(first(t1)),
        "hit": bool(first(res.hit)),
        "t": float(first(res.t)),
        "tri_id": int(first(res.tri_id)),
        "steps": int(first(res.steps)),
    }
    if not out["hit"]:
        return out

    # the hit's geometry in numpy, as the JAX package takes it
    tri = int(out["tri_id"])
    verts = prep.scene.verts.detach().cpu().numpy()
    faces = prep.scene.faces.cpu().numpy()
    tv = verts[faces[tri]]
    poi = first(ray.orig) + first(ray.dirn) * out["t"]
    light = prep.scene.light_pos.detach().cpu().numpy()
    if serial:
        normal = np.cross(tv[0] - tv[1], tv[2] - tv[0])
    else:
        normal = np.cross(tv[2] - tv[1], tv[0] - tv[1])
    sdir = -(light - poi) if rcfg.shadow_dir_away_from_light() else (light - poi)
    sdir = sdir / np.linalg.norm(sdir)
    srays = RayBatch.make(torch.from_numpy(poi[None]).to(dev),
                          torch.from_numpy(sdir[None]).to(dev), mint=rcfg.shadow_mint())
    if mesh is not None:
        sb = trace_ring(prep, srays, mesh, t_gate=rcfg.shadow_eps, stop_first=True,
                        ring_grids=ring_grids)
        in_shadow = bool(first(sb["hit"]))
    elif packed:
        sres = traverse_packed(srays, prep.packed.arrays, prep.packed.meta,
                               t_gate=rcfg.shadow_eps, stop_on_first_hit=True, consts=consts)
        in_shadow = bool(first(sres.hit))
    else:
        sres = traverse_grid(srays, prep.grid.arrays, prep.grid.meta, tri9,
                             t_gate=rcfg.shadow_eps, det_dtype=rcfg.det_dtype, tables=prep.dda)
        in_shadow = bool(first(rcfg.accepted_hit(sres)))

    extra = prep.scene.extra_light_pos
    out.update({
        "poi": poi.tolist(),
        "normal": normal.tolist(),
        "material_index": int(prep.scene.face_material[tri]),
        # shadow_dir and in_shadow are the primary light's shadow ray;
        # extra_lights counts the further lights the render also shades
        "shadow_dir": sdir.tolist(),
        "in_shadow": in_shadow,
        "extra_lights": 0 if extra is None else int(extra.shape[0]),
        "triangle": tv.tolist(),
    })
    return out


__all__ = ["trace_pixel"]
