"""The cross-depth GI wave: kernel F and its plain version.

Counterpart of `ray_tracer_tpu/ops/gi_wave.py:gi_wave_trace`: a lane
serves one pixel's whole path-traced estimate over the packed grid,

    primary march -> NEE shadow -> bounce (sample 0) -> NEE -> ... ->
    restart at the shared depth-0 vertex (sample 1) -> ... -> radiance

and writes the radiance summed over the S samples (the caller divides by
S).  The primary is marched once a pixel: every sample shares its depth-0
vertex and the depth-0 NEE contribution d0.  A vertex resolves through
`slot_tri` and its (F, 10) triangle row; the integrator's point uses the
recomputed t (`cramer_t_safe`), the NEE shadow ray starts from the
march's t.  A `reflective` material with km > 0 takes the mirror branch
with probability km (one hash draw a vertex; the restarts draw with
their own salts), and a mirror vertex skips NEE except at depth 0, whose
shadow ray still settles d0.  Escapes take the flat background, or the
environment map (`env_image`) by the escaping direction.  With smooth
normals (`fvn9`, the (F, 9) corner normals) the vertex's normal is the
corner normals interpolated at the hit's barycentrics and normalized
twice; with a texture (`fuv7`, the (F, 7) corner uvs and has-uv flag;
checker mode, or image mode with `tex_image`) the albedo is the raw
base color (`bc255_table`) times the texture factor, clipped to [0, 1].
A segment that has stepped more than `_default_max_steps(meta)` times
retires as it stands (the JAX loop's per-segment bound).

The JAX wave stages an environment escape and resolves it in one merged
lookup a round later, a device for the TPU's gathers; here an escape
looks its radiance up at once.  The value and the order of the sums are
the same: the escape is the last term of its sample, and a pixel whose
primary misses sums its lookup S times from zero.

The radiance does not depend on the schedule: the JAX loop's `wave`,
`pump`, `refill_retries` and `max_iters` decide only how its W lanes take
turns, so they are accepted and have no effect here
(tests/test_torch_gi_wave.py pins that JAX's own image is the same at two
settings).  `gi_wave_plain` is one lock-step lane per pixel running the
JAX `transition` after every `_march_step`, one elementwise op at a
time; `gi_wave_cuda` launches `csrc/gi_wave.cu` (kernel F), with the
plain version's radiance and counters bit for bit: stage P makes each
pixel's camera ray itself (`csrc/camera.cuh`) from host-held launch
values, marches the primary and the depth-0 shadow ray and queues each
hit's depth-0 record; a persistent stage S serves the (queued pixel,
sample) items, each from its first bounce, since a pixel's samples are
independent once d0 is settled; a fold sums each pixel's samples in
order.
`gi_wave_trace` takes the kernel for a grid on the card and the plain
version over the `camera_rays` batch for one on the CPU.

The sharded queue of the JAX wave is not served (its arguments raise
NotImplementedError).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ray_tracer_tpu_torch.accel.packed import PackedGridArrays, PackedGridMeta
from ray_tracer_tpu_torch.config import CameraConfig
from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.kernels import _build
from ray_tracer_tpu_torch.models.scenes import sample_env_image, texture_factor
from ray_tracer_tpu_torch.ops.camera import CameraLaunch, camera_launch, camera_rays
from ray_tracer_tpu_torch.ops.intersect import cramer_bg_safe, cramer_t_safe
from ray_tracer_tpu_torch.ops.traverse_packed import (
    LaunchConsts,
    _default_max_steps,
    _MarchParams,
    _march_step,
    _slab_entry,
    launch_consts,
    march_params,
)
from ray_tracer_tpu_torch.ops.whitted_wave import _CameraParams, _check_counter, _rearm
from ray_tracer_tpu_torch.render.pathtrace import (
    _INV_PI,
    _M32,
    _bg_acc,
    _cosine_sample,
    _hash_u01,
    _mul32,
    ray_sample_keys,
    sample_key,
)

_INF = float("inf")
# events_out entries (int64): primaries that entered the grid, bounce
# segments marched, NEE shadow rays marched, vertices resolved, mirror
# branches drawn, bounce rays that escaped to the background, and slots
# tested (rows tested x block_tris)
EVENTS = ("primaries", "bounce_segments", "shadow_rays", "vertices", "mirror_draws",
          "escapes", "slot_tests")


def gi_wave_plain(
    rays: RayBatch, light_pos, light_intensity, albedo_table, tri9,
    grid: PackedGridArrays, meta: PackedGridMeta, km_table=None, *,
    S: int, D: int, gate0: float = 0.0, gate_b: float = 1e-4, eps: float = 1e-4,
    smint: float = 1e-4, quirk: bool = False, bg=(0.0, 0.0, 0.0),
    env_image=None, fvn9=None, fuv7=None, tex_image=None, bc255_table=None,
    tex_scale: float = 1.0, capped_out=None, passes_out=None, events_out=None,
) -> torch.Tensor:
    """Radiance summed over S samples of every pixel's camera ray -> (R, 3)
    f32: the JAX wave's lane state machine with one lock-step lane a pixel.
    env_image, fvn9, fuv7, tex_image, bc255_table and tex_scale are the
    appearance tables (`_appearance`).

    Optional counters, overwritten: capped_out (1,) int32 lanes a segment
    of which reached the step bound; passes_out (1,) int32 tested slots
    that passed the barycentric test; events_out (7,) int64 the counts
    named in EVENTS."""
    f32 = torch.float32
    o0 = rays.orig.to(f32)
    d0 = rays.dirn.to(f32)
    dev = o0.device
    r = o0.shape[0]
    for name, buf, shape in (("capped_out", capped_out, (1,)), ("passes_out", passes_out, (1,))):
        _check_counter(name, buf, shape, dev)
    if events_out is not None and (events_out.dtype != torch.int64
                                   or tuple(events_out.shape) != (len(EVENTS),)
                                   or events_out.device != dev):
        raise ValueError(f"events_out must be a ({len(EVENTS)},) int64 tensor on {dev}")

    def full(x):
        return torch.full((r,), float(np.float32(x)), dtype=f32, device=dev)

    zf = torch.zeros((r,), dtype=f32, device=dev)
    zi = torch.zeros((r,), dtype=torch.int32, device=dev)
    zb = torch.zeros((r,), dtype=torch.bool, device=dev)
    z3 = torch.zeros((r, 3), dtype=f32, device=dev)
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    maxt0 = rays.maxt.to(f32)
    app = _appearance(dev, env_image, fvn9, fuv7, tex_image, bc255_table, tex_scale)
    t0, entered = _slab_entry(grid, o0, d0, rays.mint.to(f32), maxt0)
    s = dict(o=o0, d=d0, maxt=maxt0, gate=full(gate0), alive=entered, testing=zb, t_cur=t0,
             t_exit_cell=zf, first_blk=zi, n_blk=zi, cursor=zi, best_t=zf + inf, best_blk=zi,
             best_slot=zi, phase=zb, lsteps=zi, depth=zi, samp=zi,
             key0=ray_sample_keys(rays.orig, rays.dirn), rad=z3, vcur=z3, tpt=z3 + 1.0,
             pend=z3, nrm=z3, alb=z3, vpos=z3, idir=z3, vspec=zb, vkm=zf, idir0=z3, km0=zf,
             d0=z3, poi0=z3, n0=z3, alb0=z3)
    bg_acc = torch.tensor(_bg_acc(bg, S), dtype=f32, device=dev)
    bg3 = torch.tensor(bg, dtype=f32, device=dev)
    if app["env"] is None:
        out = bg_acc.expand(r, 3).clone()
    else:  # a pixel that misses the grid sums its lookup S times
        out = _s_fold(sample_env_image(app["env"], vm.normalize(d0)), S)
    stats = dict(tested=zi.clone(), touched=None,
                 passes=torch.zeros((), dtype=torch.int64, device=dev))
    capped = zb
    events = [int(entered.sum())] + [0] * (len(EVENTS) - 1)
    c = dict(seg_bound=_default_max_steps(meta), bt=meta.block_tris,
             n_slots=grid.slot_tri.shape[0], n_faces=tri9.shape[0],
             n_mats=albedo_table.shape[0], light=light_pos.to(device=dev, dtype=f32),
             li=light_intensity.to(device=dev, dtype=f32), bg3=bg3, bg_acc=bg_acc,
             quirk=quirk, S=S, D=D, eps=eps, gate_b=gate_b, smint=full(smint),
             eps_v=full(eps), inf_v=zf + inf, alb_tab=albedo_table.to(device=dev, dtype=f32),
             km_tab=(None if km_table is None else km_table.to(device=dev, dtype=f32)),
             tri9=tri9.to(device=dev, dtype=f32), **app)
    while bool(s["alive"].any()):
        pre_alive = s["alive"]
        s = _march_step(s, o=s["o"], d=s["d"], invd=torch.reciprocal(s["d"]), gate=s["gate"],
                        maxt=s["maxt"], grid=grid, meta=meta, stats=stats)
        s["lsteps"] = s["lsteps"] + pre_alive.to(torch.int32)
        s, aux = _transition(s, pre_alive, grid, c)
        out = torch.where(aux["pix_done"][:, None], s["rad"], out)
        capped = capped | aux["timeout"]
        for k, n in aux["events"].items():
            events[EVENTS.index(k)] += n

    events[EVENTS.index("slot_tests")] = int(stats["tested"].sum()) * meta.block_tris
    if capped_out is not None:
        capped_out.fill_(int(capped.sum()))
    if passes_out is not None:
        passes_out.fill_(int(stats["passes"]))
    if events_out is not None:
        events_out.copy_(torch.tensor(events, dtype=torch.int64))
    return out


def _where3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _appearance(dev, env_image, fvn9, fuv7, tex_image, bc255_table, tex_scale) -> dict:
    """The appearance tables as float32 on dev (None where not given):
    env (Eh, Ew, 3), fvn9 (F, 9), fuv7 (F, 7), tex (Th, Tw, 3) for the
    image mode, bc255 (M, 3) the raw base color / 255, and tex_scale.  A
    texture needs fuv7 and bc255 together; tex_image without fuv7 has no
    effect."""
    if (fuv7 is None) != (bc255_table is None):
        raise ValueError("a textured wave needs fuv7 and bc255_table together")

    def f32(x, cols=None):
        if x is None:
            return None
        x = x.to(device=dev, dtype=torch.float32).contiguous()
        if cols is not None and (x.ndim != 2 or x.shape[1] != cols):
            raise ValueError(f"expected (N, {cols}) rows, got {tuple(x.shape)}")
        if cols is None and (x.ndim != 3 or x.shape[2] != 3 or x.shape[0] < 1
                             or x.shape[1] < 1):
            raise ValueError(f"expected an (H, W, 3) image, got {tuple(x.shape)}")
        return x

    return dict(env=f32(env_image), fvn9=f32(fvn9, 9), fuv7=f32(fuv7, 7),
                tex=None if fuv7 is None else f32(tex_image), bc255=f32(bc255_table, 3),
                tex_scale=float(tex_scale))


def _s_fold(x: torch.Tensor, S: int) -> torch.Tensor:
    """((0 + x) + x) + ... S times, in float32: every sample of a pixel
    whose primary misses sees the same escape."""
    acc = torch.zeros_like(x)
    for _ in range(S):
        acc = acc + x
    return acc


def _escape(c, dirs: torch.Tensor) -> torch.Tensor:
    """The radiance an escape in direction dirs sees: the environment map
    by the normalized direction, or the flat background."""
    if c["env"] is None:
        return c["bg3"]
    return sample_env_image(c["env"], vm.normalize(dirs))


def _transition(s, pre_alive, grid, c):
    """All retirement events of one step (ray_tracer_tpu/ops/gi_wave.py:
    345-743, op for op, each environment escape looked up where it
    happens): segment retirements resolve their vertex and rearm as NEE
    shadows, shadow retirements settle their contribution, and the
    sample-end cascade restarts the next sample or retires the pixel.
    Returns the new state and the step's masks and event counts."""
    where = torch.where
    alive, testing, phase = s["alive"], s["testing"], s["phase"]
    best_t = s["best_t"]
    o, d, tpt = s["o"], s["d"], s["tpt"]
    hit_now = torch.isfinite(best_t)
    walked = pre_alive & ~alive
    timeout = alive & (s["lsteps"] > c["seg_bound"])
    zf = torch.zeros_like(best_t)
    z3 = torch.zeros_like(o)
    zb = torch.zeros_like(alive)
    has_spec = c["km_tab"] is not None
    D, S = c["D"], c["S"]

    # segment retirement (path phase)
    limit = torch.minimum(s["maxt"], best_t)
    seg_done = ~phase & ((alive & ~testing & (s["t_cur"] > limit)) | walked | timeout)
    hit_p = seg_done & hit_now
    miss_p = seg_done & ~hit_now

    # vertex resolve: the recomputed-t point for the integrator, the
    # march's point for the shadow ray
    slotidx = torch.clamp(s["best_blk"] * c["bt"] + s["best_slot"], 0, c["n_slots"] - 1)
    tri = grid.slot_tri[where(hit_p, slotidx, torch.zeros_like(slotidx)).long()]
    row = c["tri9"][torch.clamp(tri, 0, c["n_faces"] - 1).long()]
    tv0, tv1, tv2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    matid = torch.clamp(row[:, 9].to(torch.int32), 0, c["n_mats"] - 1).long()
    t_re = cramer_t_safe(o, d, tv0, tv1, tv2, hit_p, det_dtype=torch.float32)
    t_r = where(hit_p, t_re, zf)
    o_safe = _where3(hit_p, o, z3)
    poi_r = o_safe + d * t_r[:, None]
    t_m = where(hit_now, best_t, zf)
    poi_m = o + d * t_m[:, None]
    gn = vm.normalize(vm.cross(tv1 - tv0, tv2 - tv0))
    fvn9, fuv7 = c["fvn9"], c["fuv7"]
    if fvn9 is not None or fuv7 is not None:
        # the hit barycentrics, shared by smooth normals and textures
        hb, hg = cramer_bg_safe(o, d, tv0, tv1, tv2, hit_p, det_dtype=torch.float32)
        alpha = 1.0 - hb - hg
        face = torch.clamp(tri, 0, c["n_faces"] - 1).long()
    if fvn9 is not None:
        crow = fvn9[face]
        sn = (alpha[:, None] * crow[:, 0:3] + hb[:, None] * crow[:, 3:6]
              + hg[:, None] * crow[:, 6:9])
        gn = vm.normalize(vm.normalize(sn))
    flip = vm.dot(gn, d) > 0.0
    n = _where3(flip, -gn, gn)
    if fuv7 is not None:
        urow = fuv7[face]
        uv = (alpha[:, None] * urow[:, 0:2] + hb[:, None] * urow[:, 2:4]
              + hg[:, None] * urow[:, 4:6])
        tex = texture_factor(uv, urow[:, 6] > 0.5, hit_p,
                             "checker" if c["tex"] is None else "image", c["tex_scale"],
                             c["tex"], torch.float32)
        alb = torch.clamp(c["bc255"][matid] * tex, 0.0, 1.0)
    else:
        alb = c["alb_tab"][matid]
    # NEE geometry
    tiny = torch.full_like(zf, float(np.float32(1e-20)))
    to_l = c["light"] - poi_r
    d2 = vm.dot(to_l, to_l)
    wl = to_l / vm.sqrt(torch.maximum(d2, tiny))[:, None]
    cos_i = torch.maximum(vm.dot(n, wl), zf)
    direct = alb * torch.tensor(_INV_PI, dtype=o.dtype, device=o.device) * (
        c["li"] * cos_i / torch.maximum(d2, tiny))[:, None]
    pend_new = tpt * direct
    # the Lambertian/mirror draw
    depth_v = s["depth"]
    key_v = sample_key(s["key0"], s["samp"].to(torch.int64))
    if has_spec:
        km_d = c["km_tab"][matid]
        u3 = _hash_u01(key_v, (_mul32(depth_v.to(torch.int64) + 1, 0x85EBCA77) + 13) & _M32)
        spec_new = hit_p & (u3 < km_d)
    else:
        km_d = zf
        spec_new = zb
    # the shadow direction from the march's point: a divide by the norm
    to_l_m = c["light"] - poi_m
    norm = vm.sqrt(vm.length2(to_l_m))[:, None]
    sdir = to_l_m / where(norm > 0, norm, torch.ones_like(norm))
    if c["quirk"]:  # Serial/raytracer.cpp:106: away from the light
        sdir = -sdir
    st0, s_entered = _slab_entry(grid, poi_m, sdir, c["smint"], c["inf_v"])
    # cos_i == 0 makes the contribution an exact zero: no shadow march;
    # a mirror vertex needs none, except at depth 0 (d0 is shared)
    want_nee = hit_p & (cos_i > 0.0) & (~spec_new | (depth_v == 0))
    shadow_go = want_nee & s_entered
    imm = hit_p & ~shadow_go
    vspec_v = where(hit_p, spec_new, s["vspec"])
    vcur = s["vcur"] + _where3(imm & ~spec_new, pend_new, z3)
    c_imm = _where3(imm, pend_new, z3)

    # shadow retirement at the first accepted hit
    sh_done = phase & ((alive & hit_now) | walked | timeout)
    occ = sh_done & hit_now
    nee_add = sh_done & ~occ
    vcur = vcur + _where3(nee_add & ~s["vspec"], s["pend"], z3)
    c_vtx = c_imm + _where3(nee_add, s["pend"], z3)

    # the vertex after NEE: fresh on hit lanes, staged on shadow lanes
    av = imm | sh_done
    nrm_v = _where3(hit_p, n, s["nrm"])
    alb_v = _where3(hit_p, alb, s["alb"])
    vpos_v = _where3(hit_p, poi_r, s["vpos"])
    idir_v = _where3(hit_p, d, s["idir"])
    km_v = where(hit_p, km_d, s["vkm"]) if has_spec else zf
    at0 = av & (depth_v == 0)
    d0 = _where3(at0, c_vtx, s["d0"])
    poi0 = _where3(at0, vpos_v, s["poi0"])
    n0 = _where3(at0, nrm_v, s["n0"])
    alb0 = _where3(at0, alb_v, s["alb0"])
    idir0 = _where3(at0, idir_v, s["idir0"])
    km0 = where(at0, km_v, s["km0"])

    # the bounce (vertex depth < D)
    saltd = depth_v.to(torch.int64) + 1
    key_s = key_v
    u1 = _hash_u01(key_s, _mul32(saltd, 0x1000193))
    u2 = _hash_u01(key_s, (_mul32(saltd, 0x5BD1E995) + 7) & _M32)
    ndir = _cosine_sample(nrm_v, u1, u2)
    one3 = torch.ones_like(o)
    if has_spec:
        mdir = idir_v - 2.0 * vm.dot(idir_v, nrm_v)[:, None] * nrm_v
        ndir = _where3(vspec_v, mdir, ndir)
        tpt_b = tpt * _where3(vspec_v, one3, alb_v)
    else:
        tpt_b = tpt * alb_v
    stb, entb = _slab_entry(grid, vpos_v, ndir, c["eps_v"], c["inf_v"])
    bounce = av & (depth_v < D)
    bounce_go = bounce & entb
    bounce_esc = bounce & ~entb
    esc = miss_p & (depth_v >= 1)
    prim_miss = miss_p & (depth_v == 0)
    vcur = vcur + _where3(bounce_esc, tpt_b * _escape(c, ndir), z3)
    vcur = vcur + _where3(esc, tpt * _escape(c, d), z3)
    E = (av & (depth_v == D)) | bounce_esc | esc

    new = dict(s, vcur=vcur, d0=d0, poi0=poi0, n0=n0, alb0=alb0, nrm=nrm_v, alb=alb_v,
               vpos=vpos_v, idir=idir_v, vspec=vspec_v, vkm=km_v, idir0=idir0, km0=km0,
               pend=_where3(shadow_go, pend_new, s["pend"]))
    new = _rearm(new, shadow_go, poi_m, sdir, st0, c["eps"], True, depth_v)
    new = _rearm(new, bounce_go, vpos_v, ndir, stb, c["gate_b"], False, depth_v + 1)
    new["tpt"] = _where3(bounce_go, tpt_b, tpt)
    ended = (seg_done | sh_done) & ~shadow_go & ~bounce_go
    new["alive"] = new["alive"] & ~ended
    new["testing"] = new["testing"] & ~ended
    ev = dict(vertices=int(hit_p.sum()), shadow_rays=int(shadow_go.sum()),
              bounce_segments=int(bounce_go.sum()), escapes=int((bounce_esc | esc).sum()),
              mirror_draws=int(spec_new.sum()))

    # the sample-end cascade: each turn banks a finished sample, then
    # restarts the next one from the shared depth-0 vertex
    pix_done = prim_miss
    miss_rad = (c["bg_acc"].expand_as(o) if c["env"] is None
                else _s_fold(_escape(c, d), S))
    rad = _where3(prim_miss, miss_rad, new["rad"])
    vcur = new["vcur"]
    samp = new["samp"]
    for _ in range(S):
        rad = rad + _where3(E, vcur, z3)
        samp_n = samp + E.to(torch.int32)
        fin = E & (samp_n >= S)
        pix_done = pix_done | fin
        re = E & ~fin
        key_r = sample_key(new["key0"], samp_n.to(torch.int64))
        if D == 0:
            # every diffuse sample's radiance is d0; a mirror draw has none
            vnext = new["d0"]
            if has_spec:
                u3r = _hash_u01(key_r, 0x85EBCA77 + 13)
                spec0 = u3r < new["km0"]
                vnext = _where3(spec0, z3, vnext)
                ev["mirror_draws"] += int((re & spec0).sum())
            vcur = _where3(re, vnext, vcur)
            E = re
            samp = samp_n
            continue
        u1r = _hash_u01(key_r, 0x1000193)
        u2r = _hash_u01(key_r, 0x5BD1E995 + 7)
        ndir_r = _cosine_sample(new["n0"], u1r, u2r)
        if has_spec:
            # a mirror draw reflects the camera ray off the depth-0 normal
            # and starts from 0 (the mirror vertex has no NEE)
            u3r = _hash_u01(key_r, 0x85EBCA77 + 13)
            spec_r = u3r < new["km0"]
            mdir0 = new["idir0"] - 2.0 * vm.dot(new["idir0"], new["n0"])[:, None] * new["n0"]
            ndir_r = _where3(spec_r, mdir0, ndir_r)
            tpt_r = _where3(spec_r, one3, new["alb0"])
            v0_r = _where3(spec_r, z3, new["d0"])
            ev["mirror_draws"] += int((re & spec_r).sum())
        else:
            spec_r = zb
            tpt_r = new["alb0"]
            v0_r = new["d0"]
        str_, entr = _slab_entry(grid, new["poi0"], ndir_r, c["eps_v"], c["inf_v"])
        goes = re & entr
        esc_r = re & ~entr
        vcur = _where3(re, v0_r, vcur)
        vcur = vcur + _where3(esc_r, tpt_r * _escape(c, ndir_r), z3)
        E = esc_r
        new = _rearm(new, goes, new["poi0"], ndir_r, str_, c["gate_b"], False,
                     torch.ones_like(samp))
        new["tpt"] = _where3(goes, tpt_r, new["tpt"])
        new["vspec"] = where(goes, spec_r, new["vspec"])
        new["idir"] = _where3(goes, ndir_r, new["idir"])
        ev["bounce_segments"] += int(goes.sum())
        ev["escapes"] += int(esc_r.sum())
        samp = samp_n
    new["rad"] = rad
    new["vcur"] = vcur
    new["samp"] = samp
    new["alive"] = new["alive"] & ~pix_done
    new["testing"] = new["testing"] & ~pix_done
    return new, dict(pix_done=pix_done, timeout=timeout, events=ev)


class _GiParams(ctypes.Structure):
    """Mirror of `GiParams` in csrc/gi_wave.cu (passed by value)."""

    _fields_ = [
        ("m", _MarchParams),
        ("li", ctypes.c_float), ("gate0", ctypes.c_float), ("gate_b", ctypes.c_float),
        ("eps", ctypes.c_float), ("smint", ctypes.c_float),
        ("bg", ctypes.c_float * 3), ("bg_acc", ctypes.c_float * 3),
        ("quirk", ctypes.c_int), ("S", ctypes.c_int), ("D", ctypes.c_int),
        ("seg_bound", ctypes.c_int), ("n_faces", ctypes.c_int), ("n_mats", ctypes.c_int),
        ("has_spec", ctypes.c_int),
    ]


class _AppearParams(ctypes.Structure):
    """Mirror of `AppearParams` in csrc/texture.cuh (passed by value)."""

    _fields_ = [
        ("env", ctypes.c_void_p), ("fvn9", ctypes.c_void_p), ("fuv7", ctypes.c_void_p),
        ("tex", ctypes.c_void_p), ("bc255", ctypes.c_void_p), ("tex_scale", ctypes.c_float),
        ("env_h", ctypes.c_int), ("env_w", ctypes.c_int), ("tex_h", ctypes.c_int),
        ("tex_w", ctypes.c_int),
    ]


def _appear_params(app: dict) -> _AppearParams:
    """Kernel F's appearance tables (`_appearance`'s, on the card) by
    pointer; a null pointer turns a feature off."""
    def ptr(x):
        return x.data_ptr() if x is not None else None

    env, tex = app["env"], app["tex"]
    return _AppearParams(
        env=ptr(env), fvn9=ptr(app["fvn9"]), fuv7=ptr(app["fuv7"]), tex=ptr(tex),
        bc255=ptr(app["bc255"]), tex_scale=app["tex_scale"],
        env_h=0 if env is None else env.shape[0], env_w=0 if env is None else env.shape[1],
        tex_h=0 if tex is None else tex.shape[0], tex_w=0 if tex is None else tex.shape[1])


def _launch_params(cam: CameraLaunch, consts: LaunchConsts, meta: PackedGridMeta, *,
                   n_slots: int, n_faces: int, n_mats: int, has_spec: bool, S: int, D: int,
                   gate0: float, gate_b: float, eps: float, smint: float, quirk: bool,
                   bg) -> "tuple[_GiParams, _CameraParams]":
    """Kernel F's launch parameters, from host values only."""
    n = cam.camera.width * cam.camera.height
    seg_bound = _default_max_steps(meta)
    march = march_params(
        consts, meta, gate=gate0, shadow_gate=eps, shadow_mint=smint, n_slots=n_slots,
        fused=0, stop_on_first_hit=0, skip_dead=0, shade_serial=0, serial_quirk=int(quirk),
        probe_chain=1, max_steps=int(seg_bound), n_rays=n, n_work=n)
    vec3 = ctypes.c_float * 3
    gi = _GiParams(
        m=march, li=consts.intensity, gate0=gate0, gate_b=gate_b, eps=eps, smint=smint,
        bg=vec3(*(float(x) for x in bg)), bg_acc=vec3(*(float(x) for x in _bg_acc(bg, S))),
        quirk=int(quirk), S=int(S), D=int(D), seg_bound=int(seg_bound), n_faces=n_faces,
        n_mats=n_mats, has_spec=int(has_spec))
    pos, u, v, w = (vec3(*b) for b in cam.basis)
    fd, aspect, half_w, half_h, fw, fh, focus = cam.scalars
    camera = _CameraParams(
        pos=pos, u=u, v=v, w=w, fd=fd, aspect=aspect, half_w=half_w, half_h=half_h, fw=fw,
        fh=fh, focus=focus, width=cam.camera.width, height=cam.camera.height, n_sub=1,
        lens=int(cam.lens))
    return gi, camera


_BLOCK = 128  # threads a block of stage P and stage S (csrc/gi_wave.cu kBlock)
_FOLD_BLOCK = 256  # threads a block of the fold (kFoldBlock)
_RECORD_BYTES = 80  # a depth-0 record: five float4 (kRecord)
_OCCUPANCY = {}  # device index -> (SMs, stage S's resident blocks an SM)


def _scratch_layout(n_pixels: int, S: int) -> dict:
    """Byte offsets of kernel F's scratch, sized for every pixel queued:
    `heads` (16 B: the queue's length and stage S's item head), a capped
    flag (int32) and a depth-0 record (80 B) a queued pixel, and v_s (3
    float32) an item (queued pixel, sample); each part 16-byte aligned.
    `total` is the bytes to allocate."""
    def up16(x):
        return -(-x // 16) * 16

    flags = 16
    recs = flags + up16(4 * n_pixels)
    v = recs + _RECORD_BYTES * n_pixels
    return dict(heads=0, flags=flags, recs=recs, v=v, total=v + up16(12 * n_pixels * S))


def _stage_launch(n_pixels: int, sms: int, per_sm: int) -> "tuple[int, int, int]":
    """Blocks of stage P (one thread a pixel), of the persistent stage S
    (every SM's resident blocks) and of the fold (a grid-stride loop over
    the queued pixels, at most 8 blocks an SM)."""
    grid_p = -(-n_pixels // _BLOCK)
    grid_s = sms * max(per_sm, 1)
    grid_fold = max(1, min(-(-n_pixels // _FOLD_BLOCK), 8 * sms))
    return grid_p, grid_s, grid_fold


def _occupancy(lib, dev: torch.device) -> "tuple[int, int]":
    """(SMs, stage S's resident blocks an SM) on dev, asked of the CUDA
    runtime once (no device synchronisation)."""
    if dev.index not in _OCCUPANCY:
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        fn = lib.gi_wave_occupancy
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(sms), ctypes.byref(per_sm))
        _build.check(err, "gi_wave occupancy")
        _OCCUPANCY[dev.index] = (sms.value, per_sm.value)
    return _OCCUPANCY[dev.index]


def _launch_fn(lib):
    fn = lib.gi_wave_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [_GiParams, _CameraParams, _AppearParams] + [p] * 12 + [i] * 3 + [p] * 5
    return fn


def gi_wave_cuda(
    camera: CameraConfig, light_pos, light_intensity, albedo_table, tri9,
    grid: PackedGridArrays, meta: PackedGridMeta, km_table=None, *,
    S: int, D: int, gate0: float = 0.0, gate_b: float = 1e-4, eps: float = 1e-4,
    smint: float = 1e-4, quirk: bool = False, bg=(0.0, 0.0, 0.0),
    env_image=None, fvn9=None, fuv7=None, tex_image=None, bc255_table=None,
    tex_scale: float = 1.0, cam: Optional[CameraLaunch] = None,
    consts: Optional[LaunchConsts] = None, capped_out=None, passes_out=None,
    events_out=None, lanes_out=None,
) -> torch.Tensor:
    """Kernel F on CUDA tensors: the radiance summed over S samples of
    every pixel of `camera` -> (H*W, 3) f32, the plain version's bits for
    the rays of `camera_rays(camera)`.  Stage P marches each pixel's
    camera ray and depth-0 shadow ray and queues the hits' depth-0
    records; a persistent stage S serves the (queued pixel, sample) items;
    the fold sums each pixel's samples in order.  The appearance tables
    (as `gi_wave_plain` takes them) select the kernels' instantiation.

    cam (`camera_launch(camera, 1)`) and consts (`launch_consts(grid,
    light_pos, light_intensity)`) are the launch's host-held values:
    given both, the call neither copies to nor from the device nor
    synchronises (stage S reads the queue's length on the device); each
    one missing is made here.  The counters are the plain version's
    (zeroed here, then filled by the launch); lanes_out (2, 3) int64, the
    kernel's own: for stage P and stage S, the warp loop iterations, the
    active lane-steps in them (lane utilisation = the second over 32 times
    the first) and the warp steps in which a lane ended a segment.  The
    scratch (`_scratch_layout`, sized for every pixel queued) is allocated
    here."""
    if not grid.blocks.is_cuda:
        raise ValueError("gi_wave_cuda takes CUDA tensors")
    if S < 1 or D < 0:
        raise ValueError(f"needs S >= 1 and D >= 0, got S={S}, D={D}")
    dev = grid.blocks.device
    if cam is None:
        cam = camera_launch(camera, 1, device=dev)
    elif cam.camera != camera or cam.spp != 1:
        raise ValueError("cam was made for another camera or spp")
    if consts is None:
        consts = launch_consts(grid, light_pos, light_intensity)
    r = camera.width * camera.height
    blocks = grid.blocks.to(torch.float32).contiguous()
    cell_info = grid.cell_info.to(torch.int32).contiguous()
    slot_tri = grid.slot_tri.to(torch.int32).contiguous()
    tri9 = tri9.to(device=dev, dtype=torch.float32).contiguous()
    albedo = albedo_table.to(device=dev, dtype=torch.float32).contiguous()
    km = (None if km_table is None
          else km_table.to(device=dev, dtype=torch.float32).contiguous())
    app = _appearance(dev, env_image, fvn9, fuv7, tex_image, bc255_table, tex_scale)
    if app["fvn9"] is not None and app["fvn9"].shape[0] != tri9.shape[0]:
        raise ValueError("fvn9 must have a row a triangle")
    if app["fuv7"] is not None and (app["fuv7"].shape[0] != tri9.shape[0]
                                    or app["bc255"].shape[0] != albedo.shape[0]):
        raise ValueError("fuv7 must have a row a triangle and bc255_table one a material")
    table = cam.table.to(device=dev, dtype=torch.float32).contiguous()
    if blocks.shape != (meta.n_blocks, meta.row_lanes):
        raise ValueError("blocks does not match the meta")
    if tri9.ndim != 2 or tri9.shape[1] != 10 or albedo.ndim != 2 or albedo.shape[1] != 3:
        raise ValueError("tri9 must be (F, 10) and albedo_table (M, 3)")
    if km is not None and tuple(km.shape) != (albedo.shape[0],):
        raise ValueError("km_table must be (M,)")
    if slot_tri.shape[0] >= (1 << 30):
        raise ValueError("slot index must fit in 30 bits")
    if r * S >= (1 << 31):
        raise ValueError("the (pixel, sample) items must fit in 31 bits")
    for name, buf, shape in (("capped_out", capped_out, (1,)), ("passes_out", passes_out, (1,))):
        _check_counter(name, buf, shape, dev)
    for name, buf, shape in (("events_out", events_out, (len(EVENTS),)),
                             ("lanes_out", lanes_out, (2, 3))):
        if buf is not None and (buf.dtype != torch.int64 or not buf.is_contiguous()
                                or tuple(buf.shape) != shape or buf.device != dev):
            raise ValueError(f"{name} must be a contiguous {shape} int64 tensor on {dev}")
    for buf in (capped_out, passes_out, events_out, lanes_out):
        if buf is not None:
            buf.zero_()
    rad = torch.empty((r, 3), dtype=torch.float32, device=dev)
    if r == 0:
        return rad
    gi, cparams = _launch_params(
        cam, consts, meta, n_slots=slot_tri.shape[0], n_faces=tri9.shape[0],
        n_mats=albedo.shape[0], has_spec=km is not None, S=S, D=D, gate0=gate0,
        gate_b=gate_b, eps=eps, smint=smint, quirk=quirk, bg=bg)
    layout = _scratch_layout(r, S)
    scratch = torch.empty((layout["total"],), dtype=torch.uint8, device=dev)
    lib = _build.library("gi_wave")
    grids = _stage_launch(r, *_occupancy(lib, dev))

    def ptr(x):
        return x.data_ptr() if x is not None else None

    base = scratch.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn(lib)(
            gi, cparams, _appear_params(app), table.data_ptr(), cell_info.data_ptr(),
            blocks.data_ptr(),
            slot_tri.data_ptr(), tri9.data_ptr(), albedo.data_ptr(), ptr(km), rad.data_ptr(),
            *(base + layout[k] for k in ("heads", "flags", "recs", "v")), *grids,
            ptr(capped_out), ptr(passes_out), ptr(events_out), ptr(lanes_out), stream)
    _build.check(err, "gi_wave")
    gi_wave_cuda.launches += 1
    return rad


gi_wave_cuda.launches = 0


def launch_inputs(prep) -> "tuple[tuple, dict]":
    """(args, kw) of `gi_wave_plain` after its rays, and of `gi_wave_cuda`
    after its camera, for a Prepared that takes the GI wave: the light,
    the tables `prepare` built (`pathtrace.GiTables`), the grid and the
    config's scalars, the scene's environment map and texture among
    them."""
    rc = prep.cfg.render
    g = prep.gi
    pg = rc.primary_gate()
    args = (prep.scene.light_pos, prep.scene.light_intensity, g.albedo, g.tri9,
            prep.packed.arrays, prep.packed.meta, g.km)
    kw = dict(S=rc.gi_samples, D=rc.gi_depth, gate0=0.0 if pg is None else pg,
              gate_b=rc.bounce_gate(), eps=rc.shadow_eps, smint=rc.shadow_mint(),
              quirk=rc.shadow_dir_away_from_light(), bg=tuple(rc.background),
              env_image=prep.scene.env_image, fvn9=g.fvn9, fuv7=g.fuv7,
              tex_image=g.tex_image, bc255_table=g.bc255, tex_scale=float(rc.texture_scale))
    return args, kw


def gi_wave_trace(
    light_pos, light_intensity, albedo_table, tri9, grid: PackedGridArrays,
    meta: PackedGridMeta, env_image=None, fvn9=None, km_table=None, fuv7=None,
    tex_image=None, bc255_table=None, *, camera, S: int, D: int, tex_scale: float = 1.0,
    wave: int = 12288, pump: int = 1, gate0: float = 0.0, gate_b: float = 1e-4,
    eps: float = 1e-4, smint: float = 1e-4, quirk: bool = False, bg=(0.0, 0.0, 0.0),
    refill_retries: int = 3, max_iters=None, pix_offset=None, pix_stride: int = 1,
    queue_len=None, tile: Optional[int] = None, cam: Optional[CameraLaunch] = None,
    consts: Optional[LaunchConsts] = None,
) -> torch.Tensor:
    """Radiance summed over S samples per pixel -> (H*W, 3) f32 on grid's
    device (the caller divides by S), with the JAX function's arguments:
    env_image (the environment map), fvn9 (smooth normals), fuv7 with
    bc255_table and, in image mode, tex_image (a texture) as
    `gi_wave_plain` takes them.

    On the card kernel F makes the camera rays itself (cam and consts,
    when given, are its host-held launch values); on the CPU the plain
    version traces the batch of `camera_rays`, `tile` pixels at a time
    (each pixel is traced on its own, so the radiance does not depend on
    it).  `wave`, `pump`, `refill_retries` and `max_iters` shape only the
    JAX lock-step loop and change no bit."""
    del wave, pump, refill_retries, max_iters
    if pix_offset is not None or pix_stride != 1 or queue_len is not None:
        raise NotImplementedError("not served by the PyTorch port yet: the sharded GI wave "
                                  "queue (pix_offset, pix_stride, queue_len)")
    kw = dict(S=S, D=D, gate0=gate0, gate_b=gate_b, eps=eps, smint=smint, quirk=quirk,
              bg=tuple(bg), env_image=env_image, fvn9=fvn9, fuv7=fuv7, tex_image=tex_image,
              bc255_table=bc255_table, tex_scale=tex_scale)
    args = (light_pos, light_intensity, albedo_table, tri9, grid, meta, km_table)
    dev = grid.blocks.device
    if grid.blocks.is_cuda:
        return gi_wave_cuda(camera, *args, cam=cam, consts=consts, **kw)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    rays = camera_rays(camera, device=dev)
    return rays.map_tiles(lambda rb: gi_wave_plain(rb, *args, **kw),
                          rays.count if tile is None else tile)


__all__ = ["EVENTS", "gi_wave_cuda", "gi_wave_plain", "gi_wave_trace", "launch_inputs"]
