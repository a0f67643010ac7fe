"""The renderer: camera -> traversal -> shading -> framebuffer.

Counterpart of `ray_tracer_tpu/render/renderer.py` (`prepare`,
`choose_inline_layout`, `choose_block_tris`, `make_traversal`,
`shadow_rays_for`, `render_rays`, `accumulate_spp`,
`whitted_wave_eligible`, `_render_whitted_wave`, `render`) for the
Whitted pipeline over the CSR grid, the all-pairs sweep or the packed
grid:

  * configs that `whitted_wave_eligible` admits (the turbo parallel
    scene) render through the cross-depth Whitted wave
    (ops/whitted_wave.py, kernel E): one lane a pixel subsample serves
    its whole mirror recursion;
  * otherwise each spp subsample's primary rays are one batch (spp > 1
    folds the batches in turn, `accumulate_spp`); on the card every trace is
    one kernel launch over the whole batch, on the CPU the batch is cut
    into `ray_tile` chunks for the plain versions (each ray is traced on
    its own, so the image does not depend on the cut, nor on the JAX
    package's entry sort of the tiled packed path);
  * traversal="packed" marches the packed grid (kernel C): with
    fused_shadow the primary and its shadow ray are one march, at every
    depth under scheduler="persistent" and at depth 0 under "tiled";
  * the traversal finds the hit topology only; t, the hit point, the
    normal and the shading are recomputed from it in plain tensor code,
    t with `cramer_t_safe` in the determinant type;
  * mirror bounces run up to `max_bounces`, retired lanes get +inf
    origins so the traversal drops them at entry, and the per-depth
    colors fold deepest-first as the reference's recursion associates
    (Parallel/raytracer.cu:508-520);
  * the appearance epilogues: a texture (checker or image) modulates the
    hit's base color, smooth normals replace the facet normal's direction
    (vertex normals built once by `frame_setup`), and misses see the
    scene's environment map by this depth's ray direction instead of the
    flat background;
  * the shadow-side epilogues: every extra point light adds its own
    shadow-tested direct term (ambient rides the primary light's, once),
    and an area light (shadow_samples > 1, light_radius > 0) averages the
    occlusion of a fixed sample set (`occlusion_toward`), whose rays ride
    standalone traces of shadow_sample_batch samples each; the fused
    march then keeps only the primary point light's shadow.

gi_samples > 0 renders path-traced instead (`render/pathtrace.py`: the
GI wave, kernel F, when `gi_wave_eligible`, else the segment
integrator).  Transmissive (glass) materials render path-traced only, as
in the JAX package.  dtype="float64" makes the camera rays float64: the
CSR walk takes them as they are (kernel B's f64-ray instantiations), the
packed march float32 copies, and the epilogue runs on them; both waves
refuse it, as in the JAX package.  No option is silently ignored
(`check_supported`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ray_tracer_tpu_torch.accel.grid import UniformGrid, build_grid
from ray_tracer_tpu_torch.accel.packed import PackedGrid, pack_grid
from ray_tracer_tpu_torch.config import RenderConfig, SceneConfig
from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.device import resolve_device, same_device
from ray_tracer_tpu_torch.models.scenes import (
    Scene,
    extra_light_tables,
    scene_from_numpy,
    scene_numpy_arrays,
    texture_factor,
)
from ray_tracer_tpu_torch.ops.brute_intersect import intersect_brute_kernel, triangle_table
from ray_tracer_tpu_torch.ops.camera import (
    CameraLaunch,
    camera_launch,
    camera_rays,
    camera_rays_subsample,
    fold_subsamples,
)
from ray_tracer_tpu_torch.ops.intersect import cramer_bg_safe, cramer_t_safe, intersect_brute
from ray_tracer_tpu_torch.ops.shade import (
    apply_shadow,
    hit_geometry_parallel,
    hit_geometry_serial,
    interpolate_normal,
    light_sample_offsets,
    shade_direct_parallel,
    shade_direct_serial,
    shade_parallel,
    shade_serial,
    vertex_normals,
)
from ray_tracer_tpu_torch.ops.persistent import persistent_trace
from ray_tracer_tpu_torch.ops.traverse import DdaTables, dda_tables, traverse_grid, vertex_table
from ray_tracer_tpu_torch.ops.traverse_packed import (
    LaunchConsts,
    PackedTraceResult,
    chord_keys,
    launch_consts,
    traverse_packed,
    traverse_packed_fused_shadow,
)
from ray_tracer_tpu_torch.ops.whitted_wave import build_wave_tables, whitted_wave_trace
from ray_tracer_tpu_torch.render.pathtrace import (
    build_gi_wave_tables,
    gi_wave_eligible,
    render_pt,
    use_gi_wave_spec,
)
from ray_tracer_tpu_torch.utils.timing import part

TRAVERSALS = ("csr", "brute", "brute_pallas", "packed")
_DET_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def has_extra_lights(cfg: SceneConfig, scene: Scene = None) -> bool:
    """Does the frame shade extra point lights?  The scene's when one is
    given, and cfg's, which `prepare` attaches to a scene without them."""
    return bool(cfg.extra_lights) or (scene is not None
                                      and getattr(scene, "extra_light_pos", None) is not None)


def soft_shadows(rcfg: RenderConfig) -> bool:
    """Area-light soft shadows: several shadow samples of a light of
    positive radius."""
    return rcfg.shadow_samples > 1 and rcfg.light_radius > 0.0


def whitted_wave_eligible(cfg: SceneConfig, scene: Scene = None) -> bool:
    """Would the JAX package render this config through the cross-depth
    Whitted wave (ray_tracer_tpu/render/renderer.py:836-872)?
    whitted_wave "off" never, "auto" when eligible, "on" requires it
    (ValueError when ineligible).  The texture and environment-map tests
    read the scene when one is given."""
    rcfg = cfg.render
    knob = rcfg.whitted_wave
    if knob == "off":
        return False
    ok = (
        rcfg.gi_samples == 0
        and rcfg.traversal == "packed"
        and rcfg.scheduler == "persistent"
        and not rcfg.faithful
        and rcfg.det_dtype == "float32"
        and rcfg.dtype == "float32"
        and rcfg.normal_mode != "smooth"
        and (rcfg.texture == "none" or (scene is not None and scene.uvs is None))
        and (scene is None or scene.env_image is None)
        and not has_extra_lights(cfg, scene)
        and rcfg.soft_visibility <= 0.0
        and rcfg.soft_primary <= 0.0
        and not soft_shadows(rcfg)
        and not (cfg.camera.aperture > 0.0 and rcfg.spp <= 1)
    )
    if knob == "on" and not ok:
        raise ValueError(
            "whitted_wave='on' but the configuration is ineligible "
            "(needs packed+persistent forward, one point light, "
            "face normals, no texture/env/extra lights, no softening, "
            "float32 dets)"
        )
    return ok


def check_supported(cfg: SceneConfig, scene: Scene = None) -> bool:
    """Raise NotImplementedError for every option that changes the JAX
    package's image and that this port does not serve yet, and
    ValueError where the JAX package raises; else return whether the
    config renders through the cross-depth Whitted wave
    (`whitted_wave_eligible`: "auto" takes it when eligible, "on" with an
    ineligible config raises ValueError, as in the JAX package's render).
    A path-traced config (gi_samples > 0) never takes the Whitted wave,
    and its own wave is `pathtrace.gi_wave_eligible`'s to decide (gi_wave
    "on" with an ineligible config raises ValueError there).  A
    transmissive scene prepares either way; its Whitted render raises
    (`render`), as in the JAX package."""
    r = cfg.render
    bad = []
    if r.traversal not in TRAVERSALS:
        bad.append(f"traversal={r.traversal!r}")
    if r.dtype not in _DET_DTYPES:
        bad.append(f"dtype={r.dtype!r}")
    if bad:
        raise NotImplementedError(
            "not served by the PyTorch port yet: " + ", ".join(bad)
        )
    if r.det_dtype not in _DET_DTYPES:
        raise ValueError(f"unknown det_dtype {r.det_dtype!r}")
    if r.texture not in ("none", "checker", "image"):
        raise ValueError(f"unknown texture mode {r.texture!r}")
    env = scene is not None and scene.env_image is not None
    if r.faithful and (r.normal_mode == "smooth" or env or soft_shadows(r)):
        raise ValueError("smooth normals / area-light soft shadows / environment maps "
                         "require faithful=False")
    if r.spp < 1:
        raise ValueError(f"spp must be >= 1, got {r.spp}")
    if r.gi_samples > 0:
        if r.faithful:
            raise ValueError("path tracing requires faithful=False")
        if r.gi_depth < 0:
            raise ValueError(f"gi_depth must be >= 0, got {r.gi_depth}")
        wave = False
    else:
        wave = whitted_wave_eligible(cfg, scene)
    if r.traversal == "brute_pallas" and r.faithful:
        raise ValueError("traversal='brute_pallas' has production semantics "
                         "only (faithful=False)")
    if r.traversal == "packed":
        if r.faithful:
            raise ValueError("traversal='packed' requires faithful=False")
        if r.grid_layout not in ("auto", "inline", "blocks"):
            raise ValueError(f"unknown grid_layout {r.grid_layout!r}")
    return wave


def shadow_rays_for(rcfg: RenderConfig, light_pos, poi, hit) -> RayBatch:
    """Shadow rays toward light_pos from the hit points `poi`, per the
    shared policy (direction quirk, mint); non-hit lanes get +inf origins
    so the traversal retires them at entry."""
    nsd = vm.normalize(light_pos - poi)
    sdir = -nsd if rcfg.shadow_dir_away_from_light() else nsd
    sorig = torch.where(hit[:, None], poi, torch.full_like(poi, math.inf))
    return RayBatch.make(sorig, sdir, mint=rcfg.shadow_mint())


def _detached(rays: RayBatch) -> RayBatch:
    """The batch cut from autograd: what a trace takes (the JAX package's
    stop_gradient before each traversal)."""
    return RayBatch(*(x.detach() for x in rays))


def _soften(srays: RayBatch, occ, tri10, shadow_tri, shadow_hit_rec, ddt, s: float):
    """Soft visibility (JAX renderer.py:542-562): the recorded blocker's
    barycentric margin, recomputed from the differentiable vertices,
    squashed to sigmoid(margin / s): 1 deep inside the blocker, 0.5 at
    its silhouette, 0 where no shadow ray was occluded.  Hard occlusion
    has zero-measure gradients.  s <= 0 (off) returns occ as it is."""
    if s <= 0.0:
        return occ
    stv = vm.take(tri10, torch.clamp(shadow_tri, min=0).long())
    sbeta, sgamma = cramer_bg_safe(srays.orig, srays.dirn, stv[:, 0:3], stv[:, 3:6],
                                   stv[:, 6:9], shadow_hit_rec, det_dtype=ddt)
    margin = torch.minimum(torch.minimum(sbeta, sgamma), 1.0 - sbeta - sgamma).to(torch.float32)
    f = vm.sigmoid(vm.div_scalar(margin, s))
    return torch.where(occ, f, torch.zeros_like(f))


def _persistent_as_packed(res) -> PackedTraceResult:
    """A fused/persistent trace result as the tiled march's result type
    (the production convention: any_pass == hit)."""
    return PackedTraceResult(any_pass=res.hit, hit=res.hit, t=res.t,
                             tri_id=res.tri_id, steps=res.steps)


class FrameSetup(NamedTuple):
    """The facts every frame of `cfg` reuses, settled once: whether it
    renders through the Whitted wave (`check_supported`) or, path-traced,
    through the GI wave (`pathtrace.gi_wave_eligible`) and with its mirror
    mix (`use_gi_wave_spec`), and for the packed grid the kernels'
    host-held launch values (the grid box, cell widths and light) and a
    wave's camera launch (the basis and the subsample table), so that a
    wave frame on the card neither reads the device nor synchronises."""

    cfg: SceneConfig
    wave: bool
    consts: LaunchConsts = None
    cam: CameraLaunch = None
    gi_wave: bool = False
    gi_spec: bool = False
    vn: torch.Tensor = None  # smooth normals' vertex-normal table (V, 3)


def frame_setup(cfg: SceneConfig, scene: Scene, packed: PackedGrid = None) -> FrameSetup:
    """Settle cfg's frame facts: the only device reads, made once.  With
    smooth normals the vertex-normal table is built here, in the bounce
    loop's shading convention (the path tracer's is the parallel one)."""
    takes_wave = check_supported(cfg, scene)
    rcfg = cfg.render
    gi_wave = rcfg.gi_samples > 0 and gi_wave_eligible(cfg, scene)
    vn = None
    if rcfg.normal_mode == "smooth":
        vn = vertex_normals(scene.verts, scene.faces,
                            rcfg.serial_shading and rcfg.gi_samples == 0)
    consts = cam = None
    if packed is not None:
        consts = launch_consts(packed.arrays, scene.light_pos, scene.light_intensity)
        if takes_wave:
            cam = camera_launch(cfg.camera, cfg.render.spp, device=scene.device)
        elif gi_wave:
            cam = camera_launch(cfg.camera, 1, device=scene.device)
    return FrameSetup(cfg=cfg, wave=takes_wave, consts=consts, cam=cam, gi_wave=gi_wave,
                      gi_spec=gi_wave and use_gi_wave_spec(scene, cfg.render), vn=vn)


class Prepared(NamedTuple):
    scene: Scene
    grid: UniformGrid
    cfg: SceneConfig
    packed: PackedGrid = None  # built when cfg.render.traversal == "packed"
    dda: DdaTables = None  # kernel B's tables, built when traversal == "csr"
    wave: tuple = None  # kernel E's (mat9, tri9), built when the config takes the wave
    setup: FrameSetup = None  # the frame facts of cfg
    gi: tuple = None  # kernel F's tables (pathtrace.GiTables), built when it takes the GI wave

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def frame(self) -> FrameSetup:
        """The frame facts of cfg: prepare's, or made anew for a Prepared
        whose cfg was swapped after it was made."""
        if self.setup is not None and self.setup.cfg == self.cfg:
            return self.setup
        return frame_setup(self.cfg, self.scene, self.packed)


def prepare(cfg: SceneConfig, scene: Scene = None, device=None) -> Prepared:
    """Host-side setup: load the meshes, build the grid (and, for
    traversal="packed", the packed grid) in numpy, and put scene and grids
    on the device (cuda unless "cpu" is asked for; a given scene keeps its
    own device).  For traversal="csr", kernel B's tables (`dda_tables`),
    for a config that takes the Whitted wave, kernel E's
    (`build_wave_tables`), and for one that takes the GI wave, kernel F's
    (`build_gi_wave_tables`), are derived there once, and so are the frame
    facts (`frame_setup`, the smooth normals' vertex normals among them).
    cfg.extra_lights are attached to a given scene that has none (a scene
    that carries extra lights keeps its own), as in the JAX package."""
    check_supported(cfg, scene)  # raise before any work
    with part("scene"):
        if scene is None:
            dev = resolve_device(device)
            verts_np, faces_np, fmat_np, uvs_np, uvf_np = scene_numpy_arrays(cfg)
            scene = scene_from_numpy(verts_np, faces_np, fmat_np, cfg.materials,
                                     cfg.light, uvs_np, uvf_np, device=dev,
                                     extra_lights=cfg.extra_lights)
        else:
            dev = scene.device
            if device is not None and not same_device(dev, resolve_device(device)):
                raise ValueError(f"scene lies on {dev}, not on {device}")
            if cfg.extra_lights and scene.extra_light_pos is None:
                scene = scene._replace(**extra_light_tables(cfg.extra_lights,
                                                            scene.verts.dtype, dev))
            verts_np = scene.verts.cpu().numpy()
            faces_np = scene.faces.cpu().numpy()
    with part("build_grid"):
        grid = build_grid(
            verts_np, faces_np,
            resolution_multiplier=cfg.render.grid.resolution_multiplier,
            max_resolution=cfg.render.grid.max_resolution,
            exact_overlap=cfg.render.grid.exact_overlap,
            device=dev,
        )
    packed = None
    if cfg.render.traversal == "packed":
        with part("pack_grid"):
            bt = cfg.render.packed_block_tris
            if bt == 0:  # auto: the measured density rule
                bt = choose_block_tris(grid)
            layout = cfg.render.grid_layout
            inline = layout == "inline" or (layout == "auto"
                                            and choose_inline_layout(grid, bt))
            packed = pack_grid(grid, verts_np, faces_np, block_tris=bt, inline=inline,
                               leap=cfg.render.grid.leap)
    dda = None
    if cfg.render.traversal == "csr":
        with part("B_tables"):
            dda = dda_tables(grid.arrays, vertex_table(*scene.triangle_soa()))
    with part("frame_setup"):
        setup = frame_setup(cfg, scene, packed)
    wave = None
    if setup.wave:
        with part("E_tables"):
            wave = build_wave_tables(scene)
    gi = None
    if setup.gi_wave:
        with part("F_tables"):
            gi = build_gi_wave_tables(scene, cfg.render, setup.gi_spec, vn=setup.vn)
    return Prepared(scene=scene, grid=grid, cfg=cfg, packed=packed, dda=dda, wave=wave,
                    setup=setup, gi=gi)


def choose_inline_layout(grid: UniformGrid, block_tris: int,
                         budget_bytes: int = 64 << 20) -> bool:
    """grid_layout="auto": the inline (one row read a step) layout iff its
    dense first-row-per-cell table fits budget_bytes (the JAX package's
    rule, renderer.py:150-180; its 64 MB budget was set on a TPU)."""
    host = grid.host
    if host is None:
        return False
    counts = np.diff(host.cell_start)
    nx, ny, nz = grid.meta.n_voxels
    n_cells = nx * ny * nz
    row_lanes = -(-(block_tris * 9 + 2) // 128) * 128
    rows = n_cells + int(np.maximum((counts + block_tris - 1) // block_tris - 1, 0).sum())
    return rows * (row_lanes + block_tris) * 4 <= budget_bytes


def choose_block_tris(grid: UniformGrid) -> int:
    """packed_block_tris=0: round the mean triangles per occupied voxel up
    to the next row capacity, 14, 28 or 56 (renderer.py:183-199)."""
    host = grid.host
    if host is None:
        return 14
    counts = np.diff(host.cell_start)
    occ = int((counts > 0).sum())
    avg = float(counts.sum()) / max(occ, 1)
    for bt in (14, 28):
        if avg <= bt:
            return bt
    return 56


def make_traversal(rcfg: RenderConfig, grid, meta, v0, v1, v2, dda=None, consts=None):
    """The traversal-backend switch: RenderConfig.traversal (and, for
    "packed", scheduler) -> a callable trav(rays, t_gate,
    stop_on_first_hit=False, **kw) whose result has
    .any_pass/.hit/.t/.tri_id.  The persistent backend also takes
    camera=, compact= and order_keys=.  dda: kernel B's tables for "csr"
    (`Prepared.dda`; the kernel's wrapper derives them when not given);
    consts: kernel C's host-held launch values for "packed"."""
    if rcfg.traversal == "packed":
        chain = 1 if meta.inline else rcfg.probe_chain
        if rcfg.scheduler == "persistent":
            def trav(rb, t_gate, stop_on_first_hit=False, camera=None, compact=False,
                     order_keys=None):
                return _persistent_as_packed(persistent_trace(
                    rb, grid, meta, wave=rcfg.wave, pump=rcfg.pump, probe_chain=chain,
                    t_gate=0.0 if t_gate is None else t_gate,
                    stop_on_first_hit=stop_on_first_hit,
                    need_t=False,  # t is recomputed from tri_id by the caller
                    camera=camera, compact=compact, order_keys=order_keys,
                    refill_retries=rcfg.refill_retries, consts=consts,
                ))
        else:
            def trav(rb, t_gate, stop_on_first_hit=False):
                return traverse_packed(
                    rb, grid, meta, t_gate=0.0 if t_gate is None else t_gate,
                    stop_on_first_hit=stop_on_first_hit, unroll=rcfg.packed_unroll,
                    probe_chain=chain, consts=consts,
                )
    elif rcfg.traversal == "brute_pallas":
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
                det_dtype=rcfg.det_dtype, tables=dda,
            )
    return trav


def render_rays(rays: RayBatch, scene: Scene, grid, meta, rcfg: RenderConfig,
                camera_cfg=None, dda: DdaTables = None,
                consts: LaunchConsts = None, vn: torch.Tensor = None) -> torch.Tensor:
    """Trace + shade one ray batch -> (R,3) linear color.  camera_cfg is
    given only when `rays` is that camera's whole batch in pixel order
    (the persistent wave's camera refill); dda are kernel B's tables,
    consts kernel C's host-held launch values, vn the smooth normals'
    vertex-normal table (`vertex_normals`, built here when not given).

    Differentiable in the scene's vertices, materials, light and images:
    every trace takes detached inputs and finds the hit topology only (a
    no-grad island, as in the JAX package); t, the normals and the
    shading are recomputed from the gathered vertices under autograd.
    `render` runs it under torch.no_grad()."""
    serial = rcfg.serial_shading
    eps = rcfg.shadow_eps
    smooth = rcfg.normal_mode == "smooth"
    # texture is silently off without uv data, as in the JAX package
    textured = rcfg.texture != "none" and scene.uvs is not None
    if rcfg.faithful and (smooth or scene.env_image is not None):
        raise ValueError("smooth normals / area-light soft shadows / environment maps "
                         "require faithful=False")
    if smooth and vn is None:
        vn = vertex_normals(scene.verts, scene.faces, serial)
    v0, v1, v2 = scene.triangle_soa()
    # one (F,10) row per triangle: vertices and the material index
    tri10 = torch.cat([v0, v1, v2, scene.face_material.to(v0.dtype)[:, None]], dim=1)
    background = torch.tensor(rcfg.background, dtype=v0.dtype, device=v0.device)
    ddt = _DET_DTYPES[rcfg.det_dtype]
    primary_gate = rcfg.primary_gate()
    early = not rcfg.faithful
    trav = make_traversal(rcfg, grid, meta, v0.detach(), v1.detach(), v2.detach(), dda=dda,
                          consts=consts)
    light_sg = scene.light_pos.detach()
    persistent = rcfg.traversal == "packed" and rcfg.scheduler == "persistent"
    area = soft_shadows(rcfg)
    # one march for primary + shadow: the fused march traces one shadow
    # ray toward the light's centre, so an area light takes the
    # standalone shadow traces
    fused = rcfg.traversal == "packed" and rcfg.fused_shadow and not area
    offsets = None
    if area:
        # the area light's sample set, on the device once a call
        offsets = torch.from_numpy(
            light_sample_offsets(rcfg.shadow_samples, rcfg.light_radius)).to(v0.device)

    r = rays.count
    cur = rays
    inf3 = torch.full((r, 3), math.inf, dtype=v0.dtype, device=v0.device)
    locals_ = []  # per depth: (local color, continuation weight km*reflecting)
    for depth in range(rcfg.max_bounces + 1):
        # bounce depths gate t >= eps (RenderConfig.bounce_gate)
        gate_d = primary_gate if depth == 0 else rcfg.bounce_gate()
        cur_sg = _detached(cur)
        # difficulty-ordered queue for the depth-0 batch
        okeys = None
        if depth == 0 and rcfg.queue_order == "chord" and persistent:
            okeys = chord_keys(cur_sg, grid)
        fres = None
        if fused and (depth == 0 or persistent):
            # the lane rearms as its own shadow ray when its primary
            # retires: at every depth in the persistent wave, at depth 0
            # only in the tiled march
            fkw = dict(shadow_gate=eps, shadow_mint=rcfg.shadow_mint(),
                       serial_quirk=rcfg.shadow_dir_away_from_light())
            if persistent:
                fres = persistent_trace(
                    cur_sg, grid, meta, light_sg, wave=rcfg.wave, pump=rcfg.pump,
                    fuse_shadow=True, probe_chain=1 if meta.inline else rcfg.probe_chain,
                    need_t=False,  # t is recomputed from tri_id below
                    # zero-direct hits skip their shadow ray: the serial
                    # variant adds ambient after the shadow scale, so the
                    # image is unchanged (renderer.py:392-405 of JAX)
                    shadow_skip_dead=(serial and rcfg.soft_visibility <= 0.0
                                      and rcfg.normal_mode == "face"),
                    shade_serial=serial,
                    t_gate=0.0 if gate_d is None else gate_d,
                    need_shadow_tri=rcfg.soft_visibility > 0.0,
                    camera=(camera_cfg if depth == 0 and rcfg.camera_refill != "off"
                            else None),
                    compact=depth > 0, order_keys=okeys,
                    refill_retries=rcfg.refill_retries, consts=consts, **fkw,
                )
            else:
                fres = traverse_packed_fused_shadow(
                    cur_sg, grid, meta, light_sg,
                    primary_gate=0.0 if primary_gate is None else primary_gate,
                    consts=consts, **fkw,
                )
            res = _persistent_as_packed(fres)
        else:
            tkw = {}
            if persistent:
                if depth == 0 and camera_cfg is not None and rcfg.camera_refill != "off":
                    tkw["camera"] = camera_cfg
                tkw["compact"] = depth > 0  # bounce batches are mostly dead
                if okeys is not None:
                    tkw["order_keys"] = okeys
            res = trav(cur_sg, t_gate=gate_d, **tkw)
        hit = rcfg.accepted_hit(res)
        tri = torch.clamp(res.tri_id, min=0).long()

        tv = vm.take(tri10, tri)
        tv0, tv1, tv2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
        # recompute t from the hit topology (bit-identical to the
        # traversal's own t), guarded on missed lanes
        t_re = cramer_t_safe(cur.orig, cur.dirn, tv0, tv1, tv2, res.hit, det_dtype=ddt)
        t = torch.where(res.hit, t_re.to(res.t.dtype), torch.zeros_like(res.t))
        mat = scene.materials.gather(tv[:, 9].long())

        # the hit barycentrics, shared by the texture and smooth normals
        hb = hg = None
        if smooth or textured:
            hb, hg = cramer_bg_safe(cur.orig, cur.dirn, tv0, tv1, tv2, res.hit,
                                    det_dtype=ddt)
        if textured:
            # the barycentric uv's texture factor modulates base_color
            uv = scene.interpolate_uv(tri, hb.to(v0.dtype), hg.to(v0.dtype))
            has_uv = scene.uv_faces[tri][:, 0] >= 0
            tex = texture_factor(uv, has_uv, hit, rcfg.texture, rcfg.texture_scale,
                                 scene.texture_image, mat.base_color.dtype)
            mat = mat._replace(base_color=mat.base_color * tex.to(mat.base_color.dtype))

        # retired bounce lanes carry inf origins: zero them first
        orig_safe = torch.where(res.hit[:, None], cur.orig, torch.zeros_like(cur.orig))
        if serial:
            geom = hit_geometry_serial(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        else:
            geom = hit_geometry_parallel(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        geom = geom._replace(
            poi=torch.where(hit[:, None], geom.poi, torch.zeros_like(geom.poi))
        )
        if smooth:
            # the interpolated direction at the facet normal's length:
            # shading and the mirror bounce follow it
            unit = interpolate_normal(vn, scene.faces, tri, hb.to(v0.dtype), hg.to(v0.dtype))
            geom = geom._replace(normal=unit * vm.length(geom.normal)[:, None])

        # shadow batches past depth 0 are mostly dead (only reflecting
        # lanes have finite origins), and so are an area light's sample
        # batches at every depth: the persistent wave queues live rays only
        skw = {"compact": depth > 0 or area} if persistent else {}

        def occlusion_toward(lp):
            """Occlusion toward light position lp, for the primary light's
            standalone path and every extra light alike: one shadow ray's
            (bool, or soft visibility's float), or with an area light the
            mean over the sample set as a float factor.  Up to
            shadow_sample_batch samples' rays ride one trace; each
            sample's occlusion is added in sample order, so the image does
            not depend on the batch size."""
            if not area:
                srays = _detached(shadow_rays_for(rcfg, lp, geom.poi, hit))
                sres = trav(srays, t_gate=eps, stop_on_first_hit=early, **skw)
                return _soften(srays, rcfg.accepted_hit(sres) & hit, tri10, sres.tri_id,
                               sres.hit, ddt, rcfg.soft_visibility)
            n_s = rcfg.shadow_samples
            step = max(1, min(rcfg.shadow_sample_batch, n_s))
            occ = torch.zeros((r,), dtype=torch.float32, device=v0.device)
            for s0 in range(0, n_s, step):
                batches = [_detached(shadow_rays_for(rcfg, lp + off, geom.poi, hit))
                           for off in offsets[s0:s0 + step]]
                srays_all = (batches[0] if len(batches) == 1
                             else RayBatch(*(torch.cat(xs) for xs in zip(*batches))))
                sres = trav(srays_all, t_gate=eps, stop_on_first_hit=early, **skw)
                for j, srays in enumerate(batches):
                    sres_j = type(sres)(*(x[j * r:(j + 1) * r] for x in sres))
                    occ = occ + _soften(srays, rcfg.accepted_hit(sres_j) & hit, tri10,
                                        sres_j.tri_id, sres_j.hit, ddt,
                                        rcfg.soft_visibility).to(torch.float32)
            return vm.div_scalar(occ, float(n_s))

        if fres is not None:
            srays = None
            if rcfg.soft_visibility > 0.0:
                srays = _detached(shadow_rays_for(rcfg, scene.light_pos, geom.poi, hit))
            in_shadow = _soften(srays, fres.in_shadow & hit, tri10, fres.shadow_tri_id,
                                fres.in_shadow, ddt, rcfg.soft_visibility)
        else:
            in_shadow = occlusion_toward(scene.light_pos)

        if serial:
            color = shade_serial(geom, mat, scene.light_pos, scene.light_intensity,
                                 in_shadow, rcfg.shadow_scale)
        else:
            color = shade_parallel(geom, mat, scene.light_pos, in_shadow,
                                   rcfg.shadow_scale)
        if scene.extra_light_pos is not None:
            # each extra light adds its shadow-tested direct term (ambient
            # rode the primary term above, once), each through its own
            # standalone shadow trace
            for i in range(scene.extra_light_pos.shape[0]):
                lp = scene.extra_light_pos[i]
                li = scene.extra_light_intensity[i]
                occ_i = occlusion_toward(lp)
                if serial:
                    direct = shade_direct_serial(geom, mat, lp, li)
                else:
                    direct = shade_direct_parallel(geom, mat, lp) * li
                color = color + apply_shadow(direct, occ_i, rcfg.shadow_scale)

        if scene.env_image is not None:
            # misses see the environment by this depth's ray direction
            bg = scene.sample_env(vm.normalize(cur.dirn)).to(color.dtype)
        else:
            bg = background

        if rcfg.soft_primary > 0.0:
            # fade the surface into the background by tanh(margin / s),
            # 0 exactly at the silhouette (JAX renderer.py:655-677), so a
            # pixel crossing it changes continuously
            if hb is None:
                hb, hg = cramer_bg_safe(orig_safe, cur.dirn, tv0, tv1, tv2, res.hit,
                                        det_dtype=ddt)
            hm = torch.minimum(torch.minimum(hb, hg), 1.0 - hb - hg)
            hmargin = torch.maximum(hm, torch.zeros_like(hm)).to(color.dtype)
            fh = vm.tanh(vm.div_scalar(hmargin, rcfg.soft_primary))[:, None]
            color = fh * color + (1.0 - fh) * bg
        reflecting = hit & mat.reflective & (depth < rcfg.max_bounces)
        # reflective surfaces blend local*base*(1-km) + bounced*km
        # (raytracer.cu:519-520)
        local = torch.where(
            reflecting[:, None],
            color * mat.base_color * (1.0 - mat.km)[:, None],
            torch.where(hit[:, None], color, bg),
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


def accumulate_spp(one, camera_cfg, spp: int, dtype, device) -> torch.Tensor:
    """Sequential subsample accumulation -> (R, 3) colors, one subsample
    batch at a time: acc = c0; acc = acc + c_s in turn; then the mean
    (ray_tracer_tpu/render/renderer.py:796-814).  `one(rays, camera_ok)`
    traces a batch; camera_ok is True only for the spp-1 pixel-center
    batch (the persistent wave's camera refill)."""
    if spp == 1:
        return one(camera_rays(camera_cfg, dtype=dtype, device=device), True)
    return fold_subsamples(
        one(camera_rays_subsample(camera_cfg, s, spp, dtype=dtype, device=device), False)
        for s in range(spp * spp))


def whitted_wave_colors(prep: Prepared, setup: FrameSetup, **queue) -> torch.Tensor:
    """The cross-depth Whitted wave (kernel E on the card) with the JAX
    dispatch's knob mapping (renderer.py:875-899) -> (H*W, 3), or with
    `queue` (pix_offset, pix_stride, queue_len: a shard's queue) that
    queue's (queue_len, 3); its wave, pump and refill_retries shape only
    the JAX loop and are not passed.  The tables come from `prepare`; a
    Prepared whose cfg was swapped for a wave config after it was made gets
    them built here."""
    cfg = prep.cfg
    rcfg = cfg.render
    scene = prep.scene
    mat9, tri9 = prep.wave if prep.wave is not None else build_wave_tables(scene)
    pg = rcfg.primary_gate()
    return whitted_wave_trace(
        scene.light_pos, scene.light_intensity, mat9, tri9,
        prep.packed.arrays, prep.packed.meta,
        camera=cfg.camera, max_bounces=rcfg.max_bounces,
        serial=rcfg.serial_shading, spp=rcfg.spp,
        gate0=0.0 if pg is None else pg, gate_b=rcfg.bounce_gate(),
        eps=rcfg.shadow_eps, smint=rcfg.shadow_mint(),
        quirk=rcfg.shadow_dir_away_from_light(),
        shadow_scale=rcfg.shadow_scale, bg=tuple(rcfg.background),
        tile=max(1, rcfg.ray_tile), cam=setup.cam, consts=setup.consts, **queue,
    )


@torch.no_grad()
def render(prep: Prepared) -> torch.Tensor:
    """Render the prepared scene -> (H, W, 3) float32 linear color on the
    scene's device.  gi_samples > 0 renders path-traced
    (`pathtrace.render_pt`: the GI wave when eligible, else the segment
    integrator).  Otherwise configs that `whitted_wave_eligible` admits
    take the cross-depth Whitted wave, as in the JAX package's render; the
    others the bounce loop, spp subsamples accumulated in turn.  Forward
    only: it runs under torch.no_grad()."""
    cfg = prep.cfg
    setup = prep.frame()
    if cfg.render.gi_samples > 0:
        return render_pt(prep, setup)
    if prep.scene.transmissive is not None:
        raise NotImplementedError(
            "transmissive (dielectric) materials are served by the "
            "path-traced integrator only — set render.gi_samples > 0 "
            "(the Whitted recursion has no refraction branch, matching "
            "the reference's mirror-only materials)")
    if setup.wave:
        return whitted_wave_colors(prep, setup).reshape(cfg.camera.height, cfg.camera.width, 3)
    rcfg = cfg.render
    if rcfg.traversal == "packed":
        args = (prep.scene, prep.packed.arrays, prep.packed.meta, rcfg)
    else:
        args = (prep.scene, prep.grid.arrays, prep.grid.meta, rcfg)

    def one(rays, camera_ok):
        tile = rays.count if prep.device.type == "cuda" else max(1, rcfg.ray_tile)
        # the camera refill needs the camera's whole batch in one trace
        cam = cfg.camera if camera_ok and tile >= rays.count else None
        return rays.map_tiles(lambda rb: render_rays(rb, *args, camera_cfg=cam, dda=prep.dda,
                                                     consts=setup.consts, vn=setup.vn), tile)

    colors = accumulate_spp(one, cfg.camera, rcfg.spp, _DET_DTYPES[rcfg.dtype], prep.device)
    return colors.reshape(cfg.camera.height, cfg.camera.width, 3)
