"""Path-traced global illumination: the segment integrator, the sampler
and the GI wave's host side.

Counterpart of `ray_tracer_tpu/render/pathtrace.py` (`_hash_u01`,
`ray_sample_keys`, `_onb`, `_cosine_sample`, `pathtrace_rays`,
`gi_wave_eligible`, `use_gi_wave_spec`, `build_gi_wave_tables`,
`build_gi_wave_tri9`, `_render_pt_wave`, `render_pt`) for the features
the port serves: Lambertian surfaces with the Lambertian/mirror mix of
`reflective` materials (gi_specular), one point light through next-event
estimation (fused into the persistent march, gi_fuse_nee, or a separate
shadow traversal), the flat background or the scene's environment map
(by the escaping segment's direction) as escape radiance, textures
(checker or image, modulating the raw base color before the clip to
[0, 1]), smooth normals (the parallel convention's vertex normals,
interpolated and normalized twice), and sample batching
(gi_sample_batch, which changes no bit).

Sampling is a pure function of each ray's own bits, the sample and the
depth (the lowbias32 hash), so images are deterministic and independent
of the schedule.  The hash runs on uint32 values held in int64 tensors:
PyTorch's int32 shift is arithmetic and its uint32 support partial, so
every product is split into 16-bit halves and masked to 32 bits.

`_cosine_sample` takes cos and sin in float64 and rounds them to float32,
here and in kernel F (csrc/gi_wave.cu): no float32 formula found
reproduces the JAX package's `jnp.cos`/`jnp.sin` bits (ROADMAP.md, parity
hazards), and the float64 route gives the card the CPU's bits.  Against
the JAX package the sampled directions then differ in the last ulp for
about 1.3% of draws, so images agree bitwise only where radiance does not
depend on the sampled directions, and statistically elsewhere
(tests/test_torch_pathtrace.py).

Env NEE, extra lights, transmissive materials and the ring `tracer=` are
not served (`render.renderer.check_supported` and `pathtrace_rays` raise
NotImplementedError naming each).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ray_tracer_tpu_torch.config import RenderConfig, SceneConfig
from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.models.scenes import texture_factor
from ray_tracer_tpu_torch.ops.camera import camera_rays
from ray_tracer_tpu_torch.ops.intersect import cramer_bg_safe, cramer_t_safe
from ray_tracer_tpu_torch.ops.shade import interpolate_normal, vertex_normals

_INV_PI = 0.3183098861837907
_TWO_PI = 2.0 * np.pi
_SALT = 0x632BE59B  # per-sample key stride
_M32 = 0xFFFFFFFF


def _mul32(a, b):
    """(a * b) mod 2^32 for uint32 values in int64 tensors (or ints): the
    product in 16-bit halves, so no intermediate leaves int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def _hash_u01(x: torch.Tensor, salt) -> torch.Tensor:
    """lowbias32 of (x + salt) -> f32 in [0, 1).  x: uint32 keys in an
    int64 tensor; salt: a Python int (wrapped to 32 bits) or such a
    tensor."""
    if not torch.is_tensor(salt):
        salt = int(salt) & _M32
    x = ((x + salt) & _M32) ^ 0x9E3779B9
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * torch.tensor(1.0 / (1 << 24), dtype=torch.float32,
                                                       device=x.device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The f32 bits of x as uint32 values in int64."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32


def ray_sample_keys(orig: torch.Tensor, dirn: torch.Tensor) -> torch.Tensor:
    """Per-ray sample key (uint32 in int64): a hash of the ray's own bits,
    so a ray keeps its sample sequence under any padding or permutation."""
    ob, db = _bits(orig), _bits(dirn)
    return (_mul32(db[:, 0], 0x85EBCA6B) ^ _mul32(db[:, 1], 0xC2B2AE35)
            ^ _mul32(db[:, 2], 0x27D4EB2F) ^ _mul32(ob[:, 0], 0x165667B1)
            ^ _mul32(ob[:, 1], 0x9E3779B1) ^ _mul32(ob[:, 2], 0xFC0589B5))


def sample_key(key0: torch.Tensor, samp) -> torch.Tensor:
    """key0 + _SALT * (samp + 1) mod 2^32: sample samp's key."""
    return (key0 + _mul32(torch.as_tensor(samp, dtype=torch.int64, device=key0.device) + 1,
                          _SALT)) & _M32


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _onb(n: torch.Tensor):
    """Branchless orthonormal basis around unit normals (R,3), Duff et al.
    2017, op for op as the JAX package writes it -> (b1, b2)."""
    one = torch.ones_like(n[:, 2])
    s = torch.where(n[:, 2] >= 0.0, one, -one)
    a = -one / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    b1 = torch.stack([one + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], dim=-1)
    b2 = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return b1, b2


def cos_sin(phi: torch.Tensor):
    """(cos phi, sin phi) in float64 rounded to float32: the same bits on
    the card and the CPU (and in kernel F)."""
    p = phi.to(torch.float64)
    return torch.cos(p).to(torch.float32), torch.sin(p).to(torch.float32)


def _cosine_sample(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere directions around unit normals n."""
    b1, b2 = _onb(n)
    r = vm.sqrt(u1)
    phi = _f32(_TWO_PI, u2) * u2
    c, s = cos_sin(phi)
    x = r * c
    y = r * s
    z = vm.sqrt(torch.maximum(1.0 - u1, torch.zeros_like(u1)))
    return x[:, None] * b1 + y[:, None] * b2 + z[:, None] * n


def _bg_acc(bg, S: int) -> np.ndarray:
    """The background summed S times in float32, one sample at a time."""
    acc = np.zeros(3, np.float32)
    for _ in range(S):
        acc = (acc + np.asarray(bg, np.float32)).astype(np.float32)
    return acc


@torch.no_grad()
def pathtrace_rays(rays: RayBatch, scene, grid, meta, cfg: SceneConfig, tracer=None,
                   dda=None, consts=None, vn=None) -> torch.Tensor:
    """gi_samples Lambertian/mirror paths per input ray -> (R, 3) linear
    radiance (the segment integrator: one traversal per sample batch and
    depth, kernel B or C on the card).  dda: kernel B's tables; consts:
    kernel C's host-held launch values; vn: smooth normals' vertex-normal
    table in the parallel convention (built here when not given)."""
    from ray_tracer_tpu_torch.ops.persistent import persistent_trace
    from ray_tracer_tpu_torch.render.renderer import make_traversal, shadow_rays_for

    rcfg = cfg.render
    if rcfg.gi_samples <= 0:
        raise ValueError("pathtrace_rays needs gi_samples > 0")
    if rcfg.faithful:
        raise ValueError("path tracing requires faithful=False")
    if tracer is not None:
        raise NotImplementedError("not served by the PyTorch port yet: tracer= (ring GI)")
    v0, v1, v2 = scene.triangle_soa()
    tri9 = build_gi_wave_tri9(scene)
    dt = v0.dtype
    trav = make_traversal(rcfg, grid, meta, v0, v1, v2, dda=dda, consts=consts)
    persistent = rcfg.traversal == "packed" and rcfg.scheduler == "persistent"
    r = rays.count
    eps = rcfg.shadow_eps
    ddt = {"float32": torch.float32, "float64": torch.float64}[rcfg.det_dtype]
    dev = v0.device
    background = torch.tensor(rcfg.background, dtype=dt, device=dev)
    albedo_table, km_table = _material_tables(scene)
    n_mats = albedo_table.shape[0]
    smooth = rcfg.normal_mode == "smooth"
    if smooth and vn is None:
        vn = vertex_normals(scene.verts, scene.faces, serial=False)
    # texture silently off without uv data, as in the bounce loop; it
    # modulates the raw base color, clipped to [0, 1] after
    textured = rcfg.texture != "none" and scene.uvs is not None
    bc255_table = vm.div_scalar(scene.materials.base_color, 255.0) if textured else None
    lp, li = scene.light_pos, scene.light_intensity
    ray_ids = ray_sample_keys(rays.orig, rays.dirn)
    fuse_nee = persistent and rcfg.gi_fuse_nee
    inv_pi = _f32(_INV_PI, v0)
    tiny = _f32(1e-20, v0)

    def trace_batch(cur: RayBatch, key: torch.Tensor) -> torch.Tensor:
        rr = cur.count
        radiance = torch.zeros((rr, 3), dtype=dt, device=dev)
        throughput = torch.ones((rr, 3), dtype=dt, device=dev)
        path_alive = torch.ones((rr,), dtype=torch.bool, device=dev)
        inf3 = torch.full((rr, 3), float("inf"), dtype=dt, device=dev)
        z3 = torch.zeros_like(radiance)
        for depth in range(rcfg.gi_depth + 1):
            gate = rcfg.primary_gate() if depth == 0 else rcfg.bounce_gate()
            if fuse_nee:
                res = persistent_trace(
                    cur, grid, meta, lp.to(torch.float32), wave=rcfg.wave, pump=rcfg.pump,
                    t_gate=0.0 if gate is None else gate, fuse_shadow=True, shadow_gate=eps,
                    shadow_mint=rcfg.shadow_mint(),
                    serial_quirk=rcfg.shadow_dir_away_from_light(), need_t=False,
                    compact=depth > 0, consts=consts)
            else:
                tkw = {"compact": depth > 0} if persistent else {}
                res = trav(cur, t_gate=gate, **tkw)
            res_hit = res.hit
            hit = res_hit & path_alive
            # escape: the environment by this segment's direction (or the
            # background), then the path ends
            escaped = path_alive & ~res_hit
            if scene.env_image is not None:
                env = scene.sample_env(vm.normalize(cur.dirn)).to(dt)
            else:
                env = background.expand(rr, 3)
            radiance = radiance + torch.where(escaped[:, None], throughput * env, z3)

            tri = torch.clamp(res.tri_id, min=0).long()
            tv = tri9[tri]
            tv0, tv1, tv2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
            mat = tv[:, 9].to(torch.int32)
            t_re = cramer_t_safe(cur.orig, cur.dirn, tv0, tv1, tv2, res_hit, det_dtype=ddt)
            t = torch.where(res_hit, t_re.to(dt), torch.zeros_like(t_re).to(dt))
            orig_safe = torch.where(res_hit[:, None], cur.orig, torch.zeros_like(cur.orig))
            poi = orig_safe + cur.dirn * t[:, None]
            n = vm.normalize(vm.cross(tv1 - tv0, tv2 - tv0))
            if smooth or textured:
                hb, hg = cramer_bg_safe(orig_safe, cur.dirn, tv0, tv1, tv2, res_hit,
                                        det_dtype=ddt)
            if smooth:
                n = vm.normalize(interpolate_normal(vn, scene.faces, tri, hb.to(dt),
                                                    hg.to(dt)))
            flip = vm.dot(n, cur.dirn) > 0.0
            n = torch.where(flip[:, None], -n, n)
            mat_c = torch.clamp(mat, 0, n_mats - 1).long()
            if textured:
                uv = scene.interpolate_uv(tri, hb.to(dt), hg.to(dt))
                has_uv = scene.uv_faces[tri][:, 0] >= 0
                tex = texture_factor(uv, has_uv, hit, rcfg.texture, rcfg.texture_scale,
                                     scene.texture_image, dt)
                albedo = torch.clamp(bc255_table[mat_c] * tex, 0.0, 1.0)
            else:
                albedo = albedo_table[mat_c]

            # the Lambertian/mirror branch: one draw a (pixel, sample,
            # depth) takes the mirror with probability km; both branch
            # weights are km/km and (1-km)/(1-km), exactly 1
            if rcfg.gi_specular:
                km_d = km_table[mat_c]
                p_spec = km_d
                u3 = _hash_u01(key, 0x85EBCA77 * (depth + 1) + 13)
                spec = hit & (u3.to(dt) < p_spec)
                one = torch.ones_like(km_d)
                w_branch = torch.where(
                    spec, km_d / torch.where(p_spec > 0, p_spec, one),
                    (1.0 - km_d) / torch.where(p_spec < 1, 1.0 - p_spec, one))
                throughput = throughput * w_branch[:, None]
            else:
                spec = torch.zeros_like(hit)

            # next-event estimation at the diffuse vertices
            to_l = lp - poi
            d2 = vm.dot(to_l, to_l)
            wl = to_l / vm.sqrt(torch.maximum(d2, tiny))[:, None]
            cos_i = torch.maximum(vm.dot(n, wl), torch.zeros_like(d2))
            if fuse_nee:
                unoccluded = hit & ~spec & ~res.in_shadow
            else:
                srays = shadow_rays_for(rcfg, lp, poi, hit)
                skw = {"compact": True} if persistent else {}
                occ = trav(srays, t_gate=eps, stop_on_first_hit=True, **skw).hit
                unoccluded = hit & ~spec & ~occ
            direct = albedo * inv_pi * (li * cos_i / torch.maximum(d2, tiny))[:, None]
            radiance = radiance + torch.where(unoccluded[:, None], throughput * direct, z3)

            if depth == rcfg.gi_depth:
                break
            u1 = _hash_u01(key, 0x1000193 * (depth + 1))
            u2 = _hash_u01(key, 0x5BD1E995 * (depth + 1) + 7)
            ndir = _cosine_sample(n, u1, u2)
            if rcfg.gi_specular:
                mdir = cur.dirn - 2.0 * vm.dot(cur.dirn, n)[:, None] * n
                ndir = torch.where(spec[:, None], mdir, ndir)
            ndir = ndir.to(dt)
            throughput = throughput * torch.where(spec[:, None], torch.ones_like(albedo),
                                                  albedo)
            path_alive = hit
            cur = RayBatch.make(torch.where(hit[:, None], poi, inf3), ndir, mint=eps)
        return radiance

    # sample batching: up to gi_sample_batch samples ride one batch of
    # traversals; each lane's key is the same either way and the samples
    # are summed in order, so the batch size changes no bit
    S = rcfg.gi_samples
    B = max(1, min(rcfg.gi_sample_batch, S))
    acc = None
    for s0 in range(0, S, B):
        nb = min(B, S - s0)
        if nb == 1:
            parts = [trace_batch(rays, sample_key(ray_ids, s0))]
        else:
            cur0 = RayBatch(*(torch.cat([x] * nb, dim=0) for x in rays))
            samp = torch.arange(s0, s0 + nb, dtype=torch.int64, device=dev).repeat_interleave(r)
            out = trace_batch(cur0, sample_key(torch.cat([ray_ids] * nb), samp))
            parts = [out[j * r:(j + 1) * r] for j in range(nb)]
        for c in parts:
            acc = c if acc is None else acc + c
    return vm.div_scalar(acc, float(S))


def gi_wave_eligible(cfg: SceneConfig, scene=None) -> bool:
    """Would the JAX package render this GI config through the cross-depth
    GI wave (ray_tracer_tpu/render/pathtrace.py:705-740)?  gi_wave "off"
    never, "auto" when eligible, "on" requires it (ValueError when
    ineligible).  Environment maps, textures and smooth normals are
    eligible; an environment map with gi_env_nee is not (the scene, when
    given, says whether it has one).  The JAX test on extra lights and
    dielectrics always passes here: the port serves neither."""
    rcfg = cfg.render
    knob = rcfg.gi_wave
    if knob == "off":
        return False
    ok = (
        rcfg.gi_samples > 0
        and rcfg.traversal == "packed"
        and rcfg.scheduler == "persistent"
        and not rcfg.faithful
        and rcfg.det_dtype == "float32"
        and rcfg.dtype == "float32"
        and not (scene is not None and scene.env_image is not None and rcfg.gi_env_nee)
    )
    if knob == "on" and not ok:
        raise ValueError(
            "gi_wave='on' but the configuration is ineligible (needs "
            "packed+persistent, one point light, no env-NEE/extra "
            "lights/texture, float32 dets)"
        )
    return ok


def use_gi_wave_spec(scene, rcfg: RenderConfig) -> bool:
    """Does the scene need the wave's mirror mix (a host decision, made
    once)?  False keeps the pure-Lambertian wave."""
    km = np.clip(scene.materials.km.detach().cpu().numpy(), 0.0, 1.0)
    refl = scene.materials.reflective.detach().cpu().numpy().astype(np.float32)
    return bool(rcfg.gi_specular and ((km * refl) > 0.0).any())


class GiTables(NamedTuple):
    """Kernel F's tables (`prepare` builds them once): the six of the JAX
    package's `build_gi_wave_tables`, in its order, then the (F, 10)
    triangle rows."""

    albedo: torch.Tensor
    km: Optional[torch.Tensor]
    fuv7: Optional[torch.Tensor]
    tex_image: Optional[torch.Tensor]
    bc255: Optional[torch.Tensor]
    fvn9: Optional[torch.Tensor]
    tri9: torch.Tensor


def build_gi_wave_tables(scene, rcfg: RenderConfig, use_spec: bool, vn=None) -> GiTables:
    """The GI wave's tables, as the JAX package's function makes them
    (ray_tracer_tpu/render/pathtrace.py:755-791), with the triangle rows
    after them: the clipped base_color / 255; with the mirror mix the
    clipped km gated by `reflective`; with a texture and uv data the (F, 7)
    rows of corner uvs and the has-uv flag, the texture image (image mode)
    and the raw base_color / 255; with smooth normals the (F, 9) rows of
    corner normals (the parallel convention's vertex normals; vn when
    given)."""
    albedo, km = _material_tables(scene)
    fuv7 = tex_image = bc255 = fvn9 = None
    if rcfg.texture != "none" and scene.uvs is not None:
        if rcfg.texture == "image":
            if scene.texture_image is None:
                raise ValueError('cfg.render.texture == "image" but the scene has no '
                                 "texture_image")
            tex_image = scene.texture_image
        elif rcfg.texture != "checker":
            raise ValueError(f"unknown texture mode {rcfg.texture!r}")
        fuv = scene.uvs[torch.clamp(scene.uv_faces, min=0)].reshape(-1, 6)
        fhuv = (scene.uv_faces[:, 0] >= 0).to(torch.float32)[:, None]
        fuv7 = torch.cat([fuv.to(torch.float32), fhuv], dim=1)
        bc255 = vm.div_scalar(scene.materials.base_color, 255.0)
    if rcfg.normal_mode == "smooth":
        if vn is None:
            vn = vertex_normals(scene.verts, scene.faces, serial=False)
        fvn9 = vn[scene.faces].reshape(-1, 9).to(torch.float32)
    return GiTables(albedo, km if use_spec else None, fuv7, tex_image, bc255, fvn9,
                    build_gi_wave_tri9(scene))


def _material_tables(scene):
    """(albedo (M, 3), km (M,)): the clipped base_color / 255, and the
    clipped km gated by `reflective`."""
    mats = scene.materials
    albedo = torch.clamp(vm.div_scalar(mats.base_color, 255.0), 0.0, 1.0)
    km = torch.clamp(mats.km, 0.0, 1.0) * mats.reflective.to(mats.km.dtype)
    return albedo, km


def build_gi_wave_tri9(scene) -> torch.Tensor:
    """(F, 10) rows [v0, v1, v2, material index]."""
    v0, v1, v2 = scene.triangle_soa()
    return torch.cat([v0, v1, v2, scene.face_material.to(v0.dtype)[:, None]], dim=1)


def _render_pt_wave(prep, setup) -> torch.Tensor:
    """Forward GI through the cross-depth wave (kernel F on the card) ->
    (H, W, 3).  The tables come from `prepare`; a Prepared whose cfg was
    swapped after it was made gets them built here."""
    from ray_tracer_tpu_torch.ops.gi_wave import gi_wave_trace

    cfg = prep.cfg
    rcfg = cfg.render
    scene = prep.scene
    if prep.gi is not None and setup is prep.setup:
        tab = prep.gi
    else:
        tab = build_gi_wave_tables(scene, rcfg, setup.gi_spec, vn=setup.vn)
    pg = rcfg.primary_gate()
    rad = gi_wave_trace(
        scene.light_pos, scene.light_intensity, tab.albedo, tab.tri9,
        prep.packed.arrays, prep.packed.meta, scene.env_image, tab.fvn9, tab.km, tab.fuv7,
        tab.tex_image, tab.bc255, tex_scale=float(rcfg.texture_scale),
        camera=cfg.camera, S=rcfg.gi_samples, D=rcfg.gi_depth,
        wave=rcfg.wave, pump=rcfg.pump,
        gate0=0.0 if pg is None else pg, gate_b=rcfg.bounce_gate(),
        eps=rcfg.shadow_eps, smint=rcfg.shadow_mint(),
        quirk=rcfg.shadow_dir_away_from_light(), bg=tuple(rcfg.background),
        tile=max(1, rcfg.ray_tile), cam=setup.cam, consts=setup.consts,
    )
    cam = cfg.camera
    return vm.div_scalar(rad, float(rcfg.gi_samples)).reshape(cam.height, cam.width, 3)


def render_pt(prep, setup=None) -> torch.Tensor:
    """Path-traced render of a Prepared scene -> (H, W, 3) linear color:
    the GI wave when `gi_wave_eligible`, else the segment integrator over
    the config's traversal (spp does not apply, as in the JAX package)."""
    cfg = prep.cfg
    setup = prep.frame() if setup is None else setup
    if setup.gi_wave:
        return _render_pt_wave(prep, setup)
    rcfg = cfg.render
    if rcfg.traversal == "packed":
        grid, meta = prep.packed.arrays, prep.packed.meta
    else:
        grid, meta = prep.grid.arrays, prep.grid.meta
    rays = camera_rays(cfg.camera, device=prep.device)
    tile = rays.count if prep.device.type == "cuda" else max(1, rcfg.ray_tile)
    colors = rays.map_tiles(
        lambda rb: pathtrace_rays(rb, prep.scene, grid, meta, cfg, dda=prep.dda,
                                  consts=setup.consts, vn=setup.vn), tile)
    return colors.reshape(cfg.camera.height, cfg.camera.width, 3)


__all__ = [
    "GiTables", "build_gi_wave_tables", "build_gi_wave_tri9", "gi_wave_eligible",
    "pathtrace_rays",
    "ray_sample_keys", "render_pt", "sample_key", "use_gi_wave_spec",
]
