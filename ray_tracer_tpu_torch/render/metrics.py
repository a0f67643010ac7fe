"""Render statistics and the measured knob probes.

Counterpart of `ray_tracer_tpu/render/metrics.py`: `collect_render_metrics`
traces the prepared scene's primary and shadow rays under the renderer's
own policy (gates, acceptance, the shadow stop flag) and reports per-stage
statistics from the per-ray `steps` counters and the grid occupancy;
`estimate_coverage`, `choose_fused_shadow` and `choose_camera_refill` are
the probes `bench.py` picks its knobs with.  On the card each trace is one
launch of kernel B (csr) or C (packed); on the CPU the plain versions take
the rays in `ray_tile` chunks, as the JAX package's tiled trace does (each
ray is traced on its own, so the records do not depend on the cut).  The
thresholds were measured on a TPU by the JAX package and are kept as its
policy: the port's probes pick what bench.py would pick.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.ops.camera import camera_rays
from ray_tracer_tpu_torch.ops.traverse import traverse_grid, vertex_table
from ray_tracer_tpu_torch.ops.traverse_packed import _slab_entry, traverse_packed
from ray_tracer_tpu_torch.render.renderer import shadow_rays_for


def traced_in_tiles(trace, rays: RayBatch, tile: int):
    """trace(rays) on the card, one launch; on the CPU over chunks of at
    most `tile` rays, each field of the results concatenated."""
    r = rays.count
    if rays.orig.is_cuda or tile >= r:
        return trace(rays)
    parts = [trace(rays.slice(lo, min(lo + tile, r))) for lo in range(0, r, tile)]
    return type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))


def _summary(res, prefix: str, out: Dict[str, float]) -> None:
    steps = np.asarray(res["steps"])
    hit = np.asarray(res["hit"])
    out[f"{prefix}_rays"] = int(steps.size)
    out[f"{prefix}_hits"] = int(hit.sum())
    out[f"{prefix}_hit_rate"] = float(hit.mean())
    out[f"{prefix}_steps_mean"] = float(steps.mean())
    out[f"{prefix}_steps_p99"] = float(np.percentile(steps, 99))
    out[f"{prefix}_steps_max"] = int(steps.max())


def _tracer(prep):
    """trace(rays, gate, stop) over the prepared scene's traversal: the
    packed grid (C) or the CSR grid (B, with prepare's tables)."""
    rcfg = prep.cfg.render
    if rcfg.traversal == "packed":
        arrays, meta = prep.packed.arrays, prep.packed.meta
        consts = prep.frame().consts

        def trace(rb, gate, stop):
            return traverse_packed(rb, arrays, meta, t_gate=0.0 if gate is None else gate,
                                   stop_on_first_hit=stop, consts=consts)
    else:
        tri9 = vertex_table(*prep.scene.triangle_soa())

        def trace(rb, gate, stop):
            # gate=None is the faithful serial policy (any t), taken as it is
            return traverse_grid(rb, prep.grid.arrays, prep.grid.meta, tri9, t_gate=gate,
                                 early_exit=not rcfg.faithful, stop_on_first_hit=stop,
                                 det_dtype=rcfg.det_dtype, tables=prep.dda)
    return trace


def collect_render_metrics(prep) -> Dict[str, float]:
    """Trace the prepared scene's primary and shadow rays and report
    per-stage statistics plus grid occupancy (one host read)."""
    cfg = prep.cfg
    rcfg = cfg.render
    # smooth normals are shading only, but an area light's samples and spp
    # change the ray fan: refuse rather than report the wrong one
    if rcfg.shadow_samples > 1 and rcfg.light_radius > 0:
        raise NotImplementedError(
            "collect_render_metrics reports a single point-light shadow ray only")
    if rcfg.spp != 1:
        raise NotImplementedError("collect_render_metrics reports the pixel-center fan only")
    rays = camera_rays(cfg.camera, device=prep.device)
    trace = _tracer(prep)
    tile = max(1, rcfg.ray_tile)

    def run(rb, gate, stop):
        return traced_in_tiles(lambda t: trace(t, gate, stop), rb, tile)

    # gates, acceptance and the shadow stop flag are the renderer's own
    # policy (RenderConfig methods and shadow_rays_for)
    prim = run(rays, rcfg.primary_gate(), False)
    p_acc = rcfg.accepted_hit(prim)
    # misses take t = 0 so their direction math stays finite; shadow_rays_for
    # then retires them with +inf origins, as render_rays does
    poi = rays.at(torch.where(prim.hit, prim.t, torch.zeros_like(prim.t)))
    srays = shadow_rays_for(rcfg, prep.scene.light_pos, poi, p_acc)
    shad = run(srays, rcfg.shadow_eps, not rcfg.faithful)
    s_acc = rcfg.accepted_hit(shad) & p_acc

    host = {k: v.cpu().numpy() for k, v in (("p_steps", prim.steps), ("p_hit", p_acc),
                                            ("s_steps", shad.steps), ("s_hit", s_acc))}
    out: Dict[str, float] = {}
    _summary({"steps": host["p_steps"], "hit": host["p_hit"]}, "primary", out)
    _summary({"steps": host["s_steps"], "hit": host["s_hit"]}, "shadow", out)
    out["shadowed_fraction_of_hits"] = float(
        host["s_hit"].sum() / max(host["p_hit"].sum(), 1))
    gm = prep.grid.meta
    out["grid_cells"] = int(gm.total_voxels)
    out["grid_nnz"] = int(gm.nnz)
    out["grid_max_per_voxel"] = int(gm.max_per_voxel)
    if prep.packed is not None:
        out["packed_blocks"] = int(prep.packed.meta.n_blocks)
    return out


def _probe_camera(cfg, stride: int):
    return dataclasses.replace(cfg.camera, width=max(cfg.camera.width // stride, 8),
                               height=max(cfg.camera.height // stride, 8))


def choose_camera_refill(prep, threshold: float = 0.45, stride: int = 8) -> bool:
    """RenderConfig.camera_refill by the JAX package's measured rule: make
    the depth-0 rays from their pixel index iff the strided slab probe
    finds at least `threshold` of the camera rays never entering the
    grid's box."""
    rays = camera_rays(_probe_camera(prep.cfg, stride), device=prep.device)
    garr = prep.packed.arrays if prep.packed is not None else prep.grid.arrays
    _, entered = _slab_entry(garr, *(x.to(torch.float32) for x in rays))
    dead = 1.0 - float(entered.cpu().numpy().mean())
    return dead >= threshold


def estimate_coverage(prep, stride: int = 8) -> float:
    """The hit rate of every `stride`-th pixel's primary ray: one trace of
    about R / stride^2 rays (the packed grid when prepared, else the CSR
    grid)."""
    rays = camera_rays(_probe_camera(prep.cfg, stride), device=prep.device)
    if prep.packed is not None:
        res = traverse_packed(rays, prep.packed.arrays, prep.packed.meta, t_gate=0.0,
                              consts=prep.frame().consts)
    else:
        res = traverse_grid(rays, prep.grid.arrays, prep.grid.meta,
                            vertex_table(*prep.scene.triangle_soa()), t_gate=0.0,
                            early_exit=True, det_dtype=prep.cfg.render.det_dtype,
                            tables=prep.dda)
    return float(res.hit.cpu().numpy().mean())


def choose_fused_shadow(prep, threshold: float = 0.75, stride: int = 8) -> bool:
    """RenderConfig.fused_shadow by the JAX package's measured rule: always
    under the persistent scheduler; under the tiled one, fuse iff the
    coverage probe's hit rate is below `threshold`."""
    if prep.cfg.render.scheduler == "persistent":
        return True
    return estimate_coverage(prep, stride=stride) < threshold


__all__ = ["choose_camera_refill", "choose_fused_shadow", "collect_render_metrics",
           "estimate_coverage", "traced_in_tiles"]
