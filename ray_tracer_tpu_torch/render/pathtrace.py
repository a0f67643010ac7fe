"""Path-traced global illumination: the segment integrator, the sampler
and the GI wave's host side.

Counterpart of `ray_tracer_tpu/render/pathtrace.py` (`_hash_u01`,
`ray_sample_keys`, `_onb`, `_cosine_sample`, `fresnel_refract`,
`pathtrace_rays`, `gi_wave_eligible`, `use_gi_wave_spec`,
`build_gi_wave_tables`, `build_gi_wave_tri9`, `_render_pt_wave`,
`render_pt`): Lambertian surfaces with the Lambertian/mirror mix of
`reflective` materials (gi_specular); the primary and every extra point
light through next-event estimation (the one light's shadow fused into
the persistent march, gi_fuse_nee, else a separate shadow traversal per
light); the flat background or the scene's environment map (by the
escaping segment's direction) as escape radiance, and with gi_env_nee the
environment sampled at every diffuse vertex too, each estimate weighted
against the other by the balance heuristic (`EnvSampler`); glass
(transmissive materials: exact Fresnel reflect or refract, opaque to
shadow rays, as in the JAX package); textures (checker or image,
modulating the raw base color before the clip to [0, 1]); smooth normals
(the parallel convention's vertex normals, interpolated and normalized
twice); and sample batching (gi_sample_batch, which changes no bit).

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

The environment sampler's tables come from a cumsum and a sum whose
order XLA and PyTorch take differently, and its lookups from `acos` and
`atan2`, so env NEE is held to the JAX package statistically
(tests/test_torch_env_nee.py).

`pathtrace_rays(tracer=)` is the ring's interface (the JAX package's): the
tracer traces each segment (`tracer.trace`, the winner's vertices,
material and corner payload carried home by a ring orbit) and every
occlusion query (`tracer.occlude`), and the scene is a geometry-free
stub of the shading and lighting tables (`parallel.shard`'s ring GI).
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

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
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


def fresnel_refract(d_unit: torch.Tensor, n: torch.Tensor, entering: torch.Tensor,
                    ior: torch.Tensor):
    """The exact (unpolarized) Fresnel response of a dielectric interface
    -> (F (R,), mirror direction (R,3), Snell direction (R,3)).  d_unit:
    unit incident directions; n: unit normals oriented against them;
    entering: where the ray meets the front face (outside index 1); ior:
    each lane's index of refraction.  Total internal reflection comes out
    of the equations as F == 1; ior == 1 gives F == 0 at every angle."""
    one = torch.ones_like(ior)
    zero = torch.zeros_like(ior)
    cos_i = torch.clamp(-vm.dot(d_unit, n), 0.0, 1.0)
    eta = torch.where(entering, one / ior, ior)  # n1/n2 as the ray sees it
    sin2_t = eta * eta * torch.maximum(1.0 - cos_i * cos_i, zero)
    cos_t = vm.sqrt(torch.maximum(1.0 - sin2_t, zero))  # 0 under TIR
    tiny = _f32(1e-20, ior)
    rs = (eta * cos_i - cos_t) / torch.maximum(eta * cos_i + cos_t, tiny)
    rp = (eta * cos_t - cos_i) / torch.maximum(eta * cos_t + cos_i, tiny)
    F = 0.5 * (rs * rs + rp * rp)
    refl = d_unit + 2.0 * cos_i[:, None] * n
    refr = eta[:, None] * d_unit + (eta * cos_i - cos_t)[:, None] * n
    return F, refl, refr


class EnvSampler(NamedTuple):
    """The environment map's importance-sampling tables (gi_env_nee): a
    piecewise-constant (luminance + 1e-3) x sin(theta) distribution over
    the lat-long texels, with each row's exact solid angle.  Selection
    probabilities, so built from the detached map, on the host (the same
    tables on the card and the CPU) and moved to the device."""

    edges: torch.Tensor  # (He+1,) cos of the row edges
    dcos: torch.Tensor  # (He,)
    wtex: torch.Tensor  # (He*We,) texel weights
    wsum: torch.Tensor  # ()
    cdf: torch.Tensor  # (He*We,)
    texel_sr: torch.Tensor  # (He,) a texel's solid angle, row by row
    width: int

    @staticmethod
    def build(env_image: torch.Tensor) -> "EnvSampler":
        env = env_image.detach().to("cpu", torch.float32)
        he, we = env.shape[0], env.shape[1]
        pi = torch.tensor(np.pi, dtype=torch.float32)
        edges = torch.cos(vm.div_scalar(torch.arange(he + 1, dtype=torch.float32), float(he))
                          * pi)
        dcos = edges[:-1] - edges[1:]
        th_c = vm.div_scalar(torch.arange(he, dtype=torch.float32) + 0.5, float(he)) * pi
        lum = vm.div_scalar(env[..., 0] + env[..., 1] + env[..., 2], 3.0)
        wtex = ((lum + _f32(1e-3, lum)) * torch.sin(th_c)[:, None]).reshape(-1)
        wsum = wtex.sum()
        cdf = torch.cumsum(wtex, 0) / wsum
        texel_sr = _f32(2.0 * np.pi / we, dcos) * dcos
        dev = env_image.device
        return EnvSampler(*(x.to(dev) for x in (edges, dcos, wtex, wsum, cdf, texel_sr)), we)

    def _texel_pdf(self, idx: torch.Tensor, iv: torch.Tensor) -> torch.Tensor:
        return (self.wtex[idx] / self.wsum) / torch.maximum(self.texel_sr[iv],
                                                          _f32(1e-12, self.wsum))

    def pdf(self, dirs: torch.Tensor) -> torch.Tensor:
        """The sampler's per-steradian pdf at unit directions (R,3)."""
        from ray_tracer_tpu_torch.models.scenes import _to_i32

        we, he = self.width, self.dcos.shape[0]
        u = vm.div_scalar(torch.atan2(dirs[:, 2], dirs[:, 0]), 2.0 * np.pi) + 0.5
        v = vm.div_scalar(torch.acos(torch.clamp(dirs[:, 1], -1.0, 1.0)), np.pi)
        iu = torch.clamp(_to_i32(u * we), 0, we - 1)
        iv = torch.clamp(_to_i32(v * he), 0, he - 1)
        return self._texel_pdf(iv * we + iu, iv)

    def sample(self, u01: torch.Tensor, uj1: torch.Tensor, uj2: torch.Tensor):
        """u01 picks a texel, uj1 and uj2 jitter within it (uniform in
        cos theta and in phi) -> (unit directions (R,3), their pdf (R,)).
        cos and sin of phi are taken in float64 and rounded (`cos_sin`)."""
        we = self.width
        idx = torch.clamp(torch.searchsorted(self.cdf, u01), 0, self.wtex.shape[0] - 1)
        iv, iu = idx // we, idx % we
        cth = self.edges[iv] - uj1 * self.dcos[iv]
        phi = (vm.div_scalar(iu.to(torch.float32) + uj2, float(we)) - 0.5) * _f32(2.0 * np.pi,
                                                                                 uj2)
        st = vm.sqrt(torch.maximum(1.0 - cth * cth, torch.zeros_like(cth)))
        c, s = cos_sin(phi)
        return torch.stack([st * c, cth, st * s], dim=-1), self._texel_pdf(idx, iv)


def pathtrace_rays(rays: RayBatch, scene, grid, meta, cfg: SceneConfig, tracer=None,
                   dda=None, consts=None, vn=None) -> torch.Tensor:
    """gi_samples paths per input ray -> (R, 3) linear radiance (the
    segment integrator: one traversal per sample batch and depth, and one
    standalone shadow traversal per light and per env-NEE batch unless the
    one point light's shadow is fused; kernel B or C on the card).  dda:
    kernel B's tables; consts: kernel C's host-held launch values; vn:
    smooth normals' vertex-normal table in the parallel convention (built
    here when not given).

    tracer: the traversal and geometry provider of the ring (JAX
    render/pathtrace.py:170-197): tracer.trace(rays, t_gate) -> (hit,
    tv0, tv1, tv2, mat, payload), tracer.occlude(rays) -> (R,) bool, and
    tracer.carries, the payload groups it carries ("smooth": corner
    normals vn0..vn2, "uv": corner uvs uv0..uv2 and the has-uv flag huv).
    The scene's geometry is then never read (grid and meta are unused),
    misses get a substitute triangle, and nothing is fused.

    Differentiable as the JAX package's is: every trace takes detached
    inputs, and the sampled directions and the branch probabilities are
    constants, while hit distances, normals, albedos, the Fresnel weights
    (through ior), the light terms and the environment's values follow
    the scene's tensors.  `render` runs it under torch.no_grad()."""
    from ray_tracer_tpu_torch.ops.persistent import persistent_trace
    from ray_tracer_tpu_torch.render.renderer import _detached, make_traversal, shadow_rays_for

    rcfg = cfg.render
    if rcfg.gi_samples <= 0:
        raise ValueError("pathtrace_rays needs gi_samples > 0")
    if rcfg.faithful:
        raise ValueError("path tracing requires faithful=False")
    smooth = rcfg.normal_mode == "smooth"
    if tracer is None:
        v0, v1, v2 = scene.triangle_soa()
        tri9 = build_gi_wave_tri9(scene)
        dt, dev = v0.dtype, v0.device
        trav = make_traversal(rcfg, grid, meta, v0.detach(), v1.detach(), v2.detach(),
                              dda=dda, consts=consts)
        persistent = rcfg.traversal == "packed" and rcfg.scheduler == "persistent"
        if smooth and vn is None:
            vn = vertex_normals(scene.verts, scene.faces, serial=False)
        # texture silently off without uv data, as in the bounce loop; it
        # modulates the raw base color, clipped to [0, 1] after
        textured = rcfg.texture != "none" and scene.uvs is not None
    else:
        carries = getattr(tracer, "carries", ())
        if smooth and "smooth" not in carries:
            raise NotImplementedError("ring GI: this tracer does not carry the corner-normal "
                                      "payload smooth normals need")
        textured = rcfg.texture != "none" and "uv" in carries
        dt = scene.materials.base_color.dtype
        dev = scene.materials.base_color.device
        trav, persistent = None, False
    skw = {"compact": True} if persistent else {}  # shadow batches: live lanes queued
    r = rays.count
    eps = rcfg.shadow_eps
    ddt = _DTYPES[rcfg.det_dtype]
    background = torch.tensor(rcfg.background, dtype=dt, device=dev)
    albedo_table, km_table = _material_tables(scene)
    n_mats = albedo_table.shape[0]
    bc255_table = vm.div_scalar(scene.materials.base_color, 255.0) if textured else None
    # glass: a delta interface (no NEE, no mirror mix, no albedo), where an
    # exact-Fresnel draw reflects or refracts
    has_diel = scene.transmissive is not None
    if has_diel:
        trans_table, ior_table = scene.transmissive, scene.ior.to(dt)
    # point lights: the primary and the extras, each by next-event estimation
    lights = [(scene.light_pos, scene.light_intensity)]
    if scene.extra_light_pos is not None:
        lights += [(scene.extra_light_pos[i], scene.extra_light_intensity[i])
                   for i in range(scene.extra_light_pos.shape[0])]
    env_nee = rcfg.gi_env_nee and scene.env_image is not None
    sampler = EnvSampler.build(scene.env_image) if env_nee else None
    ray_ids = ray_sample_keys(rays.orig, rays.dirn)
    # the one point light's shadow rides the persistent march
    fuse_nee = persistent and rcfg.gi_fuse_nee and len(lights) == 1
    lp0 = scene.light_pos.detach().to(torch.float32)
    inv_pi = _f32(_INV_PI, background)
    tiny = _f32(1e-20, background)

    def occluded(srays: RayBatch) -> torch.Tensor:
        if tracer is not None:
            return tracer.occlude(srays)
        return trav(srays, t_gate=eps, stop_on_first_hit=True, **skw).hit

    def trace_batch(cur: RayBatch, key: torch.Tensor) -> torch.Tensor:
        rr = cur.count
        radiance = torch.zeros((rr, 3), dtype=dt, device=dev)
        throughput = torch.ones((rr, 3), dtype=dt, device=dev)
        path_alive = torch.ones((rr,), dtype=torch.bool, device=dev)
        inf3 = torch.full((rr, 3), float("inf"), dtype=dt, device=dev)
        z3 = torch.zeros_like(radiance)
        # the cosine pdf of the segment's sampled direction (0 for camera
        # and mirror segments: weight 1 on escape)
        bsdf_pdf = torch.zeros((rr,), dtype=torch.float32, device=dev)
        for depth in range(rcfg.gi_depth + 1):
            gate = rcfg.primary_gate() if depth == 0 else rcfg.bounce_gate()
            cur_sg = _detached(cur)
            if tracer is not None:
                res_hit, tv0, tv1, tv2, mat, payload = tracer.trace(
                    cur_sg, 0.0 if gate is None else gate)
            elif fuse_nee:
                res = persistent_trace(
                    cur_sg, grid, meta, lp0, wave=rcfg.wave, pump=rcfg.pump,
                    t_gate=0.0 if gate is None else gate, fuse_shadow=True, shadow_gate=eps,
                    shadow_mint=rcfg.shadow_mint(),
                    serial_quirk=rcfg.shadow_dir_away_from_light(), need_t=False,
                    compact=depth > 0, consts=consts)
            else:
                tkw = {"compact": depth > 0} if persistent else {}
                res = trav(cur_sg, t_gate=gate, **tkw)
            if tracer is None:
                res_hit = res.hit
            hit = res_hit & path_alive
            # escape: the environment by this segment's direction (or the
            # background), then the path ends
            escaped = path_alive & ~res_hit
            if scene.env_image is not None:
                env = scene.sample_env(vm.normalize(cur.dirn)).to(dt)
            else:
                env = background.expand(rr, 3)
            if env_nee:
                # balance-heuristic MIS against the env sampler at the
                # previous diffuse vertex
                pe = sampler.pdf(vm.normalize(cur_sg.dirn.to(torch.float32)))
                w_mis = torch.where(bsdf_pdf > 0.0, bsdf_pdf / (bsdf_pdf + pe),
                                    torch.ones_like(pe)).to(dt)
                env = env * w_mis[:, None]
            radiance = radiance + torch.where(escaped[:, None], throughput * env, z3)

            if tracer is None:
                tri = torch.clamp(res.tri_id, min=0).long()
                tv = vm.take(tri9, tri)
                tv0, tv1, tv2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
                mat = tv[:, 9].detach().to(torch.int32)
            else:
                # the carried payload; misses get a constant triangle so
                # that normalize and cross stay NaN-free
                h3 = res_hit[:, None]
                ex = torch.zeros_like(tv0)
                ex[:, 0] = 1.0
                ey = torch.zeros_like(tv0)
                ey[:, 1] = 1.0
                tv0 = torch.where(h3, tv0, torch.zeros_like(tv0)).to(dt)
                tv1 = torch.where(h3, tv1, ex).to(dt)
                tv2 = torch.where(h3, tv2, ey).to(dt)
            t_re = cramer_t_safe(cur.orig, cur.dirn, tv0, tv1, tv2, res_hit, det_dtype=ddt)
            t = torch.where(res_hit, t_re.to(dt), torch.zeros_like(t_re).to(dt))
            orig_safe = torch.where(res_hit[:, None], cur.orig, torch.zeros_like(cur.orig))
            poi = orig_safe + cur.dirn * t[:, None]
            n = vm.normalize(vm.cross(tv1 - tv0, tv2 - tv0))
            if smooth or textured:
                hb, hg = cramer_bg_safe(orig_safe, cur.dirn, tv0, tv1, tv2, res_hit,
                                        det_dtype=ddt)
            if smooth and tracer is None:
                n = vm.normalize(interpolate_normal(vn, scene.faces, tri, hb.to(dt),
                                                    hg.to(dt)))
            elif smooth:
                # the carried corner normals, Phong-interpolated as the
                # Whitted ring does
                f32 = torch.float32
                alf = (1.0 - hb - hg).to(f32)
                hbf, hgf = hb.to(f32), hg.to(f32)
                sn_raw = (alf[:, None] * payload["vn0"] + hbf[:, None] * payload["vn1"]
                          + hgf[:, None] * payload["vn2"])
                e_x = torch.zeros_like(sn_raw)
                e_x[:, 0] = 1.0
                sn = vm.normalize(torch.where(res_hit[:, None], sn_raw, e_x)).to(dt)
                n = vm.normalize(sn)
            flip = vm.dot(n, cur.dirn) > 0.0
            n = torch.where(flip[:, None], -n, n)
            mat_c = torch.clamp(mat, 0, n_mats - 1).long()
            diel = hit & trans_table[mat_c] if has_diel else torch.zeros_like(hit)
            if textured and tracer is None:
                uv = scene.interpolate_uv(tri, hb.to(dt), hg.to(dt))
                has_uv = scene.uv_faces[tri][:, 0] >= 0
            elif textured:
                ald = (1.0 - hb - hg).to(dt)
                uv = (ald[:, None] * payload["uv0"] + hb.to(dt)[:, None] * payload["uv1"]
                      + hg.to(dt)[:, None] * payload["uv2"])
                has_uv = payload["huv"]
            if textured:
                tex = texture_factor(uv, has_uv, hit, rcfg.texture, rcfg.texture_scale,
                                     scene.texture_image, dt)
                albedo = torch.clamp(vm.take(bc255_table, mat_c) * tex, 0.0, 1.0)
            else:
                albedo = vm.take(albedo_table, mat_c)

            # the Lambertian/mirror branch: one draw a (pixel, sample,
            # depth) takes the mirror with probability km (glass lanes sit
            # outside the mix); the weights divide by the constant
            # probability, each exactly 1 in value
            if rcfg.gi_specular:
                km_d = vm.take(km_table, mat_c)
                p_spec = km_d.detach()
                u3 = _hash_u01(key, 0x85EBCA77 * (depth + 1) + 13)
                spec = hit & ~diel & (u3.to(dt) < p_spec)
                one = torch.ones_like(km_d)
                w_branch = torch.where(
                    spec, km_d / torch.where(p_spec > 0, p_spec, one),
                    (1.0 - km_d) / torch.where(p_spec < 1, 1.0 - p_spec, one))
                throughput = throughput * torch.where(diel, one, w_branch)[:, None]
            else:
                spec = torch.zeros_like(hit)

            # next-event estimation toward each point light at the diffuse
            # vertices
            for lp, li in lights:
                to_l = lp - poi
                d2 = vm.dot(to_l, to_l)
                wl = to_l / vm.sqrt(torch.maximum(d2, tiny))[:, None]
                cos_i = torch.maximum(vm.dot(n, wl), torch.zeros_like(d2))
                if fuse_nee:
                    occ = res.in_shadow
                else:
                    occ = occluded(_detached(shadow_rays_for(rcfg, lp, poi, hit)))
                unoccluded = hit & ~spec & ~diel & ~occ
                direct = albedo * inv_pi * (li * cos_i / torch.maximum(d2, tiny))[:, None]
                radiance = radiance + torch.where(unoccluded[:, None], throughput * direct, z3)

            # environment NEE: one env-sampled direction a diffuse vertex,
            # shadow-tested for a clear escape, MIS-weighted against the
            # cosine sampler
            if env_nee:
                u4 = _hash_u01(key, 0x68E31DA4 * (depth + 1) + 3)
                u5 = _hash_u01(key, 0x7F4A7C15 * (depth + 1) + 11)
                u6 = _hash_u01(key, 0x94D049BB * (depth + 1) + 29)
                edir, epdf = sampler.sample(u4, u5, u6)
                edir = edir.to(dt)
                cos_e = vm.dot(n, edir)
                cos_e = torch.maximum(cos_e, torch.zeros_like(cos_e))
                live_e = hit & ~spec & ~diel & (cos_e > 0.0)
                erays = _detached(RayBatch.make(torch.where(live_e[:, None], poi, inf3), edir,
                                                mint=eps))
                e_occ = occluded(erays)
                clear = live_e & ~e_occ
                l_env = scene.sample_env(edir).to(dt)
                pc_e = cos_e.detach().to(torch.float32) * inv_pi
                w_nee = (epdf / (epdf + pc_e)).to(dt)
                contrib = (albedo * inv_pi * l_env
                           * (cos_e / torch.maximum(epdf, _f32(1e-12, epdf)).to(dt)
                              * w_nee)[:, None])
                radiance = radiance + torch.where(clear[:, None], throughput * contrib, z3)

            if depth == rcfg.gi_depth:
                break
            n_sg = n.detach()
            u1 = _hash_u01(key, 0x1000193 * (depth + 1))
            u2 = _hash_u01(key, 0x5BD1E995 * (depth + 1) + 7)
            ndir = _cosine_sample(n_sg, u1, u2)
            if rcfg.gi_specular:
                mdir = cur_sg.dirn - 2.0 * vm.dot(cur_sg.dirn, n_sg)[:, None] * n_sg
                ndir = torch.where(spec[:, None], mdir, ndir)
            if has_diel:
                # glass: one draw reflects with probability F (total
                # internal reflection gives F == 1), each branch weighted
                # by its Fresnel factor over the constant probability;
                # untinted by base_color
                F, refl_dir, refr_dir = fresnel_refract(
                    vm.normalize(cur.dirn), n, ~flip, vm.take(ior_table, mat_c))
                p_refl = F.detach()
                u7 = _hash_u01(key, 0xA0761D65 * (depth + 1) + 17)
                refl_d = diel & (u7.to(dt) < p_refl)
                one = torch.ones_like(F)
                w_diel = torch.where(
                    refl_d, F / torch.where(p_refl > 0, p_refl, one),
                    (1.0 - F) / torch.where(p_refl < 1, 1.0 - p_refl, one))
                throughput = throughput * torch.where(diel, w_diel, one)[:, None]
                ndir = torch.where(diel[:, None],
                                   torch.where(refl_d[:, None], refl_dir, refr_dir), ndir)
            ndir = ndir.detach().to(dt)
            if env_nee:
                # the next segment's cosine pdf, for its escape's MIS weight
                pc_next = torch.maximum(vm.dot(n_sg.to(torch.float32), ndir.to(torch.float32)),
                                        torch.zeros_like(bsdf_pdf)) * inv_pi
                bsdf_pdf = torch.where(spec | diel | ~hit, torch.zeros_like(pc_next), pc_next)
            throughput = throughput * torch.where((spec | diel)[:, None],
                                                  torch.ones_like(albedo), albedo)
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
    given, says whether it has one), and neither are extra lights nor glass
    (the scene's, when given; else cfg's)."""
    from ray_tracer_tpu_torch.render.renderer import has_extra_lights

    rcfg = cfg.render
    glass = (scene.transmissive is not None if scene is not None
             else any(m.transmissive for m in cfg.materials))
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
        and not has_extra_lights(cfg, scene)
        and not glass
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


def gi_wave_colors(prep, setup, **queue) -> torch.Tensor:
    """Forward GI through the cross-depth wave (kernel F on the card) ->
    (H*W, 3), or with `queue` (pix_offset, pix_stride, queue_len: a
    shard's queue) that queue's (queue_len, 3).  The tables come from
    `prepare`; a Prepared whose cfg was swapped after it was made gets them
    built here."""
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
        tile=max(1, rcfg.ray_tile), cam=setup.cam, consts=setup.consts, **queue,
    )
    return vm.div_scalar(rad, float(rcfg.gi_samples))


def render_pt(prep, setup=None) -> torch.Tensor:
    """Path-traced render of a Prepared scene -> (H, W, 3) linear color:
    the GI wave when `gi_wave_eligible`, else the segment integrator over
    the config's traversal (spp does not apply, as in the JAX package)."""
    cfg = prep.cfg
    setup = prep.frame() if setup is None else setup
    if setup.gi_wave:
        return gi_wave_colors(prep, setup).reshape(cfg.camera.height, cfg.camera.width, 3)
    rcfg = cfg.render
    if rcfg.traversal == "packed":
        grid, meta = prep.packed.arrays, prep.packed.meta
    else:
        grid, meta = prep.grid.arrays, prep.grid.meta
    rays = camera_rays(cfg.camera, dtype=_DTYPES[rcfg.dtype], device=prep.device)
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
