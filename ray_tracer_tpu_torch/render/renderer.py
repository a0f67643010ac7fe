"""The renderer: camera -> traversal -> shading -> framebuffer.

Counterpart of `ray_tracer_tpu/render/renderer.py` (`prepare`,
`make_traversal`, `shadow_rays_for`, `render_rays`, `render`) for the
Whitted pipeline over the CSR grid or the all-pairs sweep:

  * the image's primary rays are one batch; on the card every trace is
    one kernel launch over the whole batch, on the CPU the batch is cut
    into `ray_tile` chunks for the plain versions (each ray is traced on
    its own, so the image does not depend on the cut);
  * the traversal finds the hit topology only; t, the hit point, the
    normal and the shading are recomputed from it in plain tensor code,
    t with `cramer_t_safe` in the determinant type;
  * mirror bounces run up to `max_bounces`, retired lanes get +inf
    origins so the traversal drops them at entry, and the per-depth
    colors fold deepest-first as the reference's recursion associates
    (Parallel/raytracer.cu:508-520).

Options of `RenderConfig` outside this slice raise NotImplementedError
(`check_supported`); none is silently ignored.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ray_tracer_tpu_torch.accel.grid import GridArrays, GridMeta, UniformGrid, build_grid
from ray_tracer_tpu_torch.config import RenderConfig, SceneConfig
from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.device import resolve_device
from ray_tracer_tpu_torch.models.scenes import Scene, scene_from_numpy, scene_numpy_arrays
from ray_tracer_tpu_torch.ops.brute_intersect import intersect_brute_kernel, triangle_table
from ray_tracer_tpu_torch.ops.camera import camera_rays
from ray_tracer_tpu_torch.ops.intersect import cramer_t_safe, intersect_brute
from ray_tracer_tpu_torch.ops.shade import (
    hit_geometry_parallel,
    hit_geometry_serial,
    shade_parallel,
    shade_serial,
)
from ray_tracer_tpu_torch.ops.traverse import traverse_grid, vertex_table

TRAVERSALS = ("csr", "brute", "brute_pallas")
_DET_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def check_supported(cfg: SceneConfig) -> None:
    """Raise NotImplementedError for every option that changes the JAX
    package's image and that this port does not serve yet.  Knobs of the
    packed and persistent paths (`scheduler`, `wave`, `pump`, ...) do not
    apply to these traversals, as in the JAX package."""
    r = cfg.render
    bad = []
    if r.traversal not in TRAVERSALS:
        bad.append(f"traversal={r.traversal!r}")
    if r.spp != 1:
        bad.append("spp > 1")
    if cfg.camera.aperture > 0.0:
        bad.append("camera aperture (depth of field)")
    if r.texture != "none":
        bad.append(f"texture={r.texture!r}")
    if r.normal_mode != "face":
        bad.append(f"normal_mode={r.normal_mode!r}")
    if r.soft_visibility > 0.0 or r.soft_primary > 0.0:
        bad.append("soft visibility / soft primary")
    if r.shadow_samples != 1 or r.light_radius != 0.0:
        bad.append("area-light soft shadows")
    if cfg.extra_lights:
        bad.append("extra lights")
    if r.gi_samples > 0 or r.gi_wave != "off":
        bad.append("path-traced GI")
    if r.whitted_wave != "off":
        bad.append("the cross-depth Whitted wave")
    if any(m.transmissive for m in cfg.materials):
        bad.append("transmissive materials")
    if r.dtype != "float32":
        bad.append(f"dtype={r.dtype!r}")
    if bad:
        raise NotImplementedError(
            "not served by the PyTorch port yet: " + ", ".join(bad)
        )
    if r.det_dtype not in _DET_DTYPES:
        raise ValueError(f"unknown det_dtype {r.det_dtype!r}")
    if r.traversal == "brute_pallas" and r.faithful:
        raise ValueError("traversal='brute_pallas' has production semantics "
                         "only (faithful=False)")


def shadow_rays_for(rcfg: RenderConfig, light_pos, poi, hit) -> RayBatch:
    """Shadow rays toward light_pos from the hit points `poi`, per the
    shared policy (direction quirk, mint); non-hit lanes get +inf origins
    so the traversal retires them at entry."""
    nsd = vm.normalize(light_pos - poi)
    sdir = -nsd if rcfg.shadow_dir_away_from_light() else nsd
    sorig = torch.where(hit[:, None], poi, torch.full_like(poi, math.inf))
    return RayBatch.make(sorig, sdir, mint=rcfg.shadow_mint())


class Prepared(NamedTuple):
    scene: Scene
    grid: UniformGrid
    cfg: SceneConfig

    @property
    def device(self) -> torch.device:
        return self.scene.device


def prepare(cfg: SceneConfig, scene: Scene = None, device=None) -> Prepared:
    """Host-side setup: load the meshes, build the grid in numpy, and put
    scene and grid on the device (cuda unless "cpu" is asked for; a given
    scene keeps its own device)."""
    check_supported(cfg)
    if scene is None:
        dev = resolve_device(device)
        verts_np, faces_np, fmat_np, uvs_np, uvf_np = scene_numpy_arrays(cfg)
        scene = scene_from_numpy(verts_np, faces_np, fmat_np, cfg.materials,
                                 cfg.light, uvs_np, uvf_np, device=dev)
    else:
        dev = scene.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"scene lies on {dev}, not on {device}")
        verts_np = scene.verts.cpu().numpy()
        faces_np = scene.faces.cpu().numpy()
    grid = build_grid(
        verts_np, faces_np,
        resolution_multiplier=cfg.render.grid.resolution_multiplier,
        max_resolution=cfg.render.grid.max_resolution,
        exact_overlap=cfg.render.grid.exact_overlap,
        device=dev,
    )
    return Prepared(scene=scene, grid=grid, cfg=cfg)


def make_traversal(rcfg: RenderConfig, grid: GridArrays, meta: GridMeta, v0, v1, v2):
    """The traversal-backend switch: RenderConfig.traversal -> a callable
    trav(rays, t_gate, stop_on_first_hit=False) whose result has
    .any_pass/.hit/.t/.tri_id."""
    if rcfg.traversal == "brute_pallas":
        # the all-pairs sweep (kernel A); production f32 semantics
        tri9 = triangle_table(v0, v1, v2)

        def trav(rb, t_gate, stop_on_first_hit=False):
            return intersect_brute_kernel(
                rb, v0, v1, v2, t_lower=0.0 if t_gate is None else t_gate,
                tri9=tri9,
            )
    elif rcfg.traversal == "brute":
        # the reference's naive integrator, kept as an A/B cross-check
        ddt = _DET_DTYPES[rcfg.det_dtype]

        def trav(rb, t_gate, stop_on_first_hit=False):
            return intersect_brute(rb, v0, v1, v2, t_lower=t_gate, det_dtype=ddt)
    else:
        tri9 = vertex_table(v0, v1, v2)

        def trav(rb, t_gate, stop_on_first_hit=False):
            return traverse_grid(
                rb, grid, meta, tri9, t_gate=t_gate,
                early_exit=not rcfg.faithful,
                stop_on_first_hit=stop_on_first_hit,
                det_dtype=rcfg.det_dtype,
            )
    return trav


@torch.no_grad()
def render_rays(rays: RayBatch, scene: Scene, grid: GridArrays, meta: GridMeta,
                rcfg: RenderConfig) -> torch.Tensor:
    """Trace + shade one ray batch -> (R,3) linear color."""
    serial = rcfg.serial_shading
    eps = rcfg.shadow_eps
    v0, v1, v2 = scene.triangle_soa()
    # one (F,10) row per triangle: vertices and the material index
    tri10 = torch.cat([v0, v1, v2, scene.face_material.to(v0.dtype)[:, None]], dim=1)
    background = torch.tensor(rcfg.background, dtype=v0.dtype, device=v0.device)
    ddt = _DET_DTYPES[rcfg.det_dtype]
    primary_gate = rcfg.primary_gate()
    early = not rcfg.faithful
    trav = make_traversal(rcfg, grid, meta, v0, v1, v2)

    r = rays.count
    cur = rays
    inf3 = torch.full((r, 3), math.inf, dtype=v0.dtype, device=v0.device)
    locals_ = []  # per depth: (local color, continuation weight km*reflecting)
    for depth in range(rcfg.max_bounces + 1):
        # bounce depths gate t >= eps (RenderConfig.bounce_gate)
        gate_d = primary_gate if depth == 0 else rcfg.bounce_gate()
        res = trav(cur, t_gate=gate_d)
        hit = rcfg.accepted_hit(res)
        tri = torch.clamp(res.tri_id, min=0).long()

        tv = tri10[tri]
        tv0, tv1, tv2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
        # recompute t from the hit topology (bit-identical to the
        # traversal's own t), guarded on missed lanes
        t_re = cramer_t_safe(cur.orig, cur.dirn, tv0, tv1, tv2, res.hit, det_dtype=ddt)
        t = torch.where(res.hit, t_re.to(res.t.dtype), torch.zeros_like(res.t))
        mat = scene.materials.gather(tv[:, 9].long())

        # retired bounce lanes carry inf origins: zero them first
        orig_safe = torch.where(res.hit[:, None], cur.orig, torch.zeros_like(cur.orig))
        if serial:
            geom = hit_geometry_serial(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        else:
            geom = hit_geometry_parallel(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        geom = geom._replace(
            poi=torch.where(hit[:, None], geom.poi, torch.zeros_like(geom.poi))
        )

        srays = shadow_rays_for(rcfg, scene.light_pos, geom.poi, hit)
        sres = trav(srays, t_gate=eps, stop_on_first_hit=early)
        in_shadow = rcfg.accepted_hit(sres) & hit

        if serial:
            color = shade_serial(geom, mat, scene.light_pos, scene.light_intensity,
                                 in_shadow, rcfg.shadow_scale)
        else:
            color = shade_parallel(geom, mat, scene.light_pos, in_shadow,
                                   rcfg.shadow_scale)

        reflecting = hit & mat.reflective & (depth < rcfg.max_bounces)
        # reflective surfaces blend local*base*(1-km) + bounced*km
        # (raytracer.cu:519-520)
        local = torch.where(
            reflecting[:, None],
            color * mat.base_color * (1.0 - mat.km)[:, None],
            torch.where(hit[:, None], color, background),
        )
        locals_.append((local, torch.where(reflecting, mat.km,
                                           torch.zeros_like(mat.km))[:, None]))
        if depth == rcfg.max_bounces:
            break

        rdir = vm.normalize(
            vm.reflect(vm.normalize(cur.dirn), vm.normalize(geom.normal))
        )
        rorig = torch.where(reflecting[:, None], geom.poi, inf3)
        cur = RayBatch.make(rorig, rdir, mint=eps)

    # fold deepest-first: color_d = local_d + km_d * color_{d+1}
    result = locals_[-1][0]
    for local, km in reversed(locals_[:-1]):
        result = local + km * result
    return result


def render(prep: Prepared) -> torch.Tensor:
    """Render the prepared scene -> (H, W, 3) float32 linear color on the
    scene's device."""
    cfg = prep.cfg
    check_supported(cfg)
    rcfg = cfg.render
    rays = camera_rays(cfg.camera, dtype=_DET_DTYPES[rcfg.dtype], device=prep.device)
    args = (prep.scene, prep.grid.arrays, prep.grid.meta, rcfg)
    if prep.device.type == "cuda":
        colors = render_rays(rays, *args)
    else:
        tile = max(1, rcfg.ray_tile)
        colors = torch.cat([
            render_rays(rays.slice(lo, min(lo + tile, rays.count)), *args)
            for lo in range(0, rays.count, tile)
        ])
    return colors.reshape(cfg.camera.height, cfg.camera.width, 3)

