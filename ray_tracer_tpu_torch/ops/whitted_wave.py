"""The cross-depth Whitted wave: kernel E and its plain version.

Counterpart of `ray_tracer_tpu/ops/whitted_wave.py` (`build_wave_tables`,
`whitted_wave_trace`): a lane serves one queue position (a pixel
subsample) through its whole mirror recursion,

    primary march -> shadow march -> shade -> mirror bounce -> shadow ...

over the packed grid, and writes one color.  The vertex is shaded with
the wave's own Blinn-Phong expressions at the step its segment retires
(resolve through `slot_tri`, the (F, 10) triangle row and the (M, 9)
material row; t recomputed with `cramer_t_safe`; the shadow ray rearmed
from the march's hit point, the bounce from the recomputed one), and the
color accumulates forward, col += w * local with w the product of the
km's.  A segment that has stepped more than `_default_max_steps(meta)`
times retires as it stands (the JAX loop's per-segment bound).

The colors do not depend on the schedule: the JAX loop's `wave`, `pump`,
`refill_retries` and `max_iters` decide only how its W lanes take turns,
so they are accepted and have no effect here.  `whitted_wave_plain` is
one lock-step lane per queue position running the JAX `transition` after
every `_march_step`, one elementwise op at a time; it is held bitwise
against the JAX function run op by op (tests/test_torch_whitted_wave.py),
and gives the same bits for any order of the positions.
`whitted_wave_cuda` launches `csrc/whitted_wave.cu` (kernel E), which
makes each position's camera ray itself (`camera_ray_at`, the bits of
the CPU `camera_rays`) from host-held launch values (`CameraLaunch`,
`LaunchConsts`), with the plain version's colors and counters bit for
bit.  `whitted_wave_trace` takes the kernel for a grid on the card and
the plain version over the `camera_rays` batch for one on the CPU, and
folds spp > 1 subsample-major in `accumulate_spp`'s order
(`fold_subsamples`).  Both serve the JAX wave's sharded queue
(`pix_offset`, `pix_stride`, `queue_len`: position k the pixel
pix_offset + k * pix_stride), with which `parallel.shard.render_sharded`
deals the pixels over the ranks.
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
from ray_tracer_tpu_torch.ops.camera import (
    CameraLaunch,
    camera_launch,
    camera_rays,
    fold_subsamples,
    queue_rays,
)
from ray_tracer_tpu_torch.ops.intersect import cramer_t_safe
from ray_tracer_tpu_torch.ops.shade import _pow_safe, _relu
from ray_tracer_tpu_torch.ops.traverse_packed import (
    LaunchConsts,
    _default_max_steps,
    _MarchParams,
    _march_step,
    _slab_entry,
    launch_consts,
    march_params,
)

_INF = float("inf")
# events_out entries: primaries that entered the grid, vertices resolved,
# shadow rays marched, reflections computed, mirror rays marched
EVENTS = ("primaries", "vertices", "shadow_rays", "reflections", "mirror_rays")


def build_wave_tables(scene):
    """(mat9 (M, 9), tri9 (F, 10)) f32 for the wave from a Scene: material
    rows [base r, g, b, kd, ks, spec_alpha, ka, km, reflective] and
    triangle rows [v0, v1, v2, material index]."""
    v0, v1, v2 = scene.triangle_soa()
    tri9 = torch.cat([v0, v1, v2, scene.face_material.to(v0.dtype)[:, None]], dim=1)
    m = scene.materials
    mat9 = torch.stack(
        [m.base_color[:, 0], m.base_color[:, 1], m.base_color[:, 2],
         m.kd, m.ks, m.spec_alpha, m.ka, m.km, m.reflective.to(torch.float32)], dim=1)
    return mat9, tri9


def _check_counter(name, buf, shape, dev):
    if buf is not None and (buf.dtype != torch.int32 or not buf.is_contiguous()
                            or tuple(buf.shape) != shape or buf.device != dev):
        raise ValueError(f"{name} must be a contiguous {shape} int32 tensor on {dev}")


def whitted_wave_plain(
    rays: RayBatch, light_pos, light_intensity, mat9, tri9,
    grid: PackedGridArrays, meta: PackedGridMeta, *,
    max_bounces: int, serial: bool, gate0: float = 0.0, gate_b: float = 1e-4,
    eps: float = 1e-4, smint: float = 1e-4, quirk: bool = False,
    shadow_scale: float = 0.5, bg=(0.0, 0.0, 0.0),
    capped_out=None, passes_out=None, tested_out=None, touched_out=None,
    slots_out=None, events_out=None,
) -> torch.Tensor:
    """Color of every queue position (ray) -> (R, 3) f32: the JAX wave's
    lane state machine with one lock-step lane a position.

    Optional int32 counters, overwritten: capped_out (1,) lanes whose
    segment hit the step bound; passes_out (1,) tested slots that passed
    the barycentric test; tested_out (R,) rows each position tested;
    touched_out (n_blocks,) ORs 1 into rows whose header a probe read and
    2 into rows tested; slots_out (n_slots,) 1 where a vertex resolved
    that slot; events_out (5,) the counts named in EVENTS."""
    f32 = torch.float32
    o0 = rays.orig.to(f32)
    d0 = rays.dirn.to(f32)
    dev = o0.device
    r = o0.shape[0]
    bt = meta.block_tris
    n_slots, n_faces, n_mats = grid.slot_tri.shape[0], tri9.shape[0], mat9.shape[0]
    for name, buf, shape in (("capped_out", capped_out, (1,)), ("passes_out", passes_out, (1,)),
                             ("tested_out", tested_out, (r,)),
                             ("touched_out", touched_out, (meta.n_blocks,)),
                             ("slots_out", slots_out, (n_slots,)),
                             ("events_out", events_out, (len(EVENTS),))):
        _check_counter(name, buf, shape, dev)

    def full(x):
        return torch.full((r,), float(np.float32(x)), dtype=f32, device=dev)

    inf = torch.tensor(_INF, dtype=f32, device=dev)
    light = light_pos.to(device=dev, dtype=f32)
    li = light_intensity.to(device=dev, dtype=f32)
    bg3 = torch.tensor(bg, dtype=f32, device=dev)
    scale = torch.tensor(float(np.float32(shadow_scale)), dtype=f32, device=dev)
    zf = torch.zeros((r,), dtype=f32, device=dev)
    zi = torch.zeros((r,), dtype=torch.int32, device=dev)
    zb = torch.zeros((r,), dtype=torch.bool, device=dev)
    z3 = torch.zeros((r, 3), dtype=f32, device=dev)

    maxt0 = rays.maxt.to(f32)
    t0, entered = _slab_entry(grid, o0, d0, rays.mint.to(f32), maxt0)
    s = dict(o=o0, d=d0, maxt=maxt0, gate=full(gate0), alive=entered, testing=zb,
             t_cur=t0, t_exit_cell=zf, first_blk=zi, n_blk=zi, cursor=zi,
             best_t=zf + inf, best_blk=zi, best_slot=zi, phase=zb, lsteps=zi, depth=zi,
             col=z3, wgt=zf + 1.0, pA=z3, pB=z3, tint=z3, km=zf, refl_go=zb, nrm=z3,
             vpos=z3, idir=z3)
    out = bg3.expand(r, 3).clone()
    stats = None
    if tested_out is not None or touched_out is not None or passes_out is not None:
        touched = (torch.zeros((meta.n_blocks,), dtype=torch.int32, device=dev)
                   if touched_out is not None else None)
        stats = dict(tested=zi.clone(), touched=touched,
                     passes=torch.zeros((), dtype=torch.int64, device=dev))
    capped = zb
    events = [int(entered.sum()), 0, 0, 0, 0]
    slots = (torch.zeros((n_slots,), dtype=torch.int32, device=dev)
             if slots_out is not None else None)
    c = dict(seg_bound=_default_max_steps(meta), bt=bt, n_slots=n_slots, n_faces=n_faces,
             n_mats=n_mats, light=light, li=li, bg3=bg3, scale=scale, serial=serial, quirk=quirk,
             max_bounces=max_bounces, smint=full(smint), eps_v=full(eps), inf_v=zf + inf,
             eps=eps, gate_b=gate_b, mat9=mat9.to(f32), tri9=tri9.to(f32))
    while bool(s["alive"].any()):
        pre_alive = s["alive"]
        s = _march_step(s, o=s["o"], d=s["d"], invd=torch.reciprocal(s["d"]), gate=s["gate"],
                        maxt=s["maxt"], grid=grid, meta=meta, stats=stats)
        s["lsteps"] = s["lsteps"] + pre_alive.to(torch.int32)
        s, aux = _transition(s, pre_alive, grid, c)
        out = torch.where(aux["pix_done"][:, None], s["col"], out)
        capped = capped | aux["timeout"]
        for k, key in enumerate(("hitP", "shadow_go", "reflect", "bounce_go"), start=1):
            events[k] += int(aux[key].sum())
        if slots is not None:
            slots[aux["slot"][aux["hitP"]].long()] = 1

    if capped_out is not None:
        capped_out.fill_(int(capped.sum()))
    if stats is not None:
        if passes_out is not None:
            passes_out.fill_(int(stats["passes"]))
        if tested_out is not None:
            tested_out.copy_(stats["tested"])
        if touched_out is not None:
            touched_out.copy_(stats["touched"])
    if slots_out is not None:
        slots_out.copy_(slots)
    if events_out is not None:
        events_out.copy_(torch.tensor(events, dtype=torch.int32))
    return out


def _transition(s, pre_alive, grid, c):
    """Segment retirement, vertex resolve and shading, the shadow and
    bounce rearms and the forward blend, for every lane after a step
    (ray_tracer_tpu/ops/whitted_wave.py:257-431, op for op).  Returns the
    new state and the step's masks."""
    where = torch.where
    alive, testing, phase = s["alive"], s["testing"], s["phase"]
    best_t = s["best_t"]
    o, d = s["o"], s["d"]
    hit_now = torch.isfinite(best_t)
    walked = pre_alive & ~alive
    timeout = alive & (s["lsteps"] > c["seg_bound"])

    # segment retirement
    limit = torch.minimum(s["maxt"], best_t)
    seg_done = ~phase & ((alive & ~testing & (s["t_cur"] > limit)) | walked | timeout)
    hit_p = seg_done & hit_now
    miss_p = seg_done & ~hit_now

    # vertex resolve
    slotidx = torch.clamp(s["best_blk"] * c["bt"] + s["best_slot"], 0, c["n_slots"] - 1)
    tri = grid.slot_tri[where(hit_p, slotidx, torch.zeros_like(slotidx)).long()]
    row = c["tri9"][torch.clamp(tri, 0, c["n_faces"] - 1).long()]
    tv0, tv1, tv2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    matid = row[:, 9].to(torch.int32)
    m = c["mat9"][torch.clamp(matid, 0, c["n_mats"] - 1).long()]
    base = m[:, 0:3]
    kd, ks, alpha, ka, km_m = m[:, 3], m[:, 4], m[:, 5], m[:, 6], m[:, 7]
    refl = m[:, 8] > 0.5
    # the recomputed-t point shades and starts the bounce; the march-t
    # point starts the shadow ray
    t_re = cramer_t_safe(o, d, tv0, tv1, tv2, hit_p, det_dtype=torch.float32)
    t_r = where(hit_p, t_re, torch.zeros_like(t_re))
    o_safe = where(hit_p[:, None], o, torch.zeros_like(o))
    poi_r = o_safe + d * t_r[:, None]
    t_m = where(hit_now, best_t, torch.zeros_like(best_t))
    poi_m = o + d * t_m[:, None]
    if c["serial"]:  # getNormalMod, Serial/geometry.h:234-240
        n = vm.cross(tv0 - tv1, tv2 - tv0)
    else:  # Parallel/geometry.cuh:160
        n = vm.cross(tv2 - tv1, tv0 - tv1)
    view = vm.normalize(-d)
    l = vm.normalize(c["light"] - poi_r)
    # serial keeps h unnormalized (raytracer.cpp:95), parallel normalizes
    h = (view + l) if c["serial"] else vm.normalize(view + l)
    ndl = _relu(vm.dot(n, l))
    ndh = _relu(vm.dot(n, h))
    if c["serial"]:
        diffuse = base * (kd * ndl)[:, None] * c["li"]
        specular = base * (ks * _pow_safe(ndh, alpha))[:, None] * c["li"]
        a_term = specular + diffuse
        b_term = base * ka[:, None]  # ambient lands after the shadow scale
    else:
        diffuse = base * ndl[:, None] * kd[:, None]
        specular = base * _pow_safe(ndh, alpha)[:, None] * ks[:, None]
        a_term = (diffuse + specular) + base * ka[:, None]  # shadow scales ambient too
        b_term = torch.zeros_like(a_term)
    refl_go = hit_p & refl & (s["depth"] < c["max_bounces"])

    # the shadow ray from the march's point: a divide by the norm
    to_l_m = c["light"] - poi_m
    norm = vm.sqrt(vm.length2(to_l_m))[:, None]
    sdir = to_l_m / where(norm > 0, norm, torch.ones_like(norm))
    if c["quirk"]:  # Serial/raytracer.cpp:106
        sdir = -sdir
    st0, s_entered = _slab_entry(grid, poi_m, sdir, c["smint"], c["inf_v"])
    if c["serial"]:
        # exact zero-direct skip: with A == 0 occlusion changes nothing
        want_sh = hit_p & torch.any(a_term != 0.0, dim=-1)
    else:
        want_sh = hit_p
    shadow_go = want_sh & s_entered
    imm = hit_p & ~shadow_go

    # shadow retirement at the first accepted hit
    sh_done = phase & ((alive & hit_now) | walked | timeout)
    occ = sh_done & hit_now

    # at-vertex shading and the forward blend
    av = imm | sh_done
    hp3 = hit_p[:, None]
    a_v = where(hp3, a_term, s["pA"])
    b_v = where(hp3, b_term, s["pB"])
    tint_v = where(hp3, base, s["tint"])
    km_v = where(hit_p, km_m, s["km"])
    rgo_v = where(hit_p, refl_go, s["refl_go"])
    nrm_v = where(hp3, n, s["nrm"])
    vpos_v = where(hp3, poi_r, s["vpos"])
    idir_v = where(hp3, d, s["idir"])  # the incident ray survives the shadow march
    color_v = where(occ[:, None], a_v * c["scale"], a_v) + b_v
    local = where(rgo_v[:, None], color_v * tint_v * (1.0 - km_v)[:, None], color_v)
    z3 = torch.zeros_like(local)
    col = s["col"] + where(av[:, None], s["wgt"][:, None] * local, z3)
    col = col + where(miss_p[:, None], s["wgt"][:, None] * c["bg3"], z3)
    wgt = where(av & rgo_v, s["wgt"] * km_v, s["wgt"])

    # the mirror bounce: normalize(reflect(normalize(idir), normalize(n)))
    nd = vm.normalize(idir_v)
    nn = vm.normalize(nrm_v)
    rdir = vm.normalize(nd - nn * (2.0 * vm.dot(nd, nn))[:, None])
    stb, entb = _slab_entry(grid, vpos_v, rdir, c["eps_v"], c["inf_v"])
    reflect = av & rgo_v
    bounce_go = reflect & entb
    bounce_esc = reflect & ~entb
    col = col + where(bounce_esc[:, None], wgt[:, None] * c["bg3"], z3)  # next depth's miss
    pix_done = miss_p | (av & ~bounce_go)

    new = dict(s, col=col, wgt=wgt, pA=a_v, pB=b_v, tint=tint_v, km=km_v, refl_go=rgo_v,
               nrm=nrm_v, vpos=vpos_v, idir=idir_v)
    new = _rearm(new, shadow_go, poi_m, sdir, st0, c["eps"], True, s["depth"])
    new = _rearm(new, bounce_go, vpos_v, rdir, stb, c["gate_b"], False, s["depth"] + 1)
    ended = (seg_done | sh_done) & ~shadow_go & ~bounce_go
    new["alive"] = new["alive"] & ~ended & ~pix_done
    new["testing"] = new["testing"] & ~ended & ~pix_done
    return new, dict(pix_done=pix_done, timeout=timeout, hitP=hit_p, shadow_go=shadow_go,
                     reflect=reflect, bounce_go=bounce_go, slot=slotidx)


def _rearm(cur, mask, o_n, d_n, t0_n, gate_n, phase_n, depth_n):
    """Start a new segment in place on the masked lanes."""
    where = torch.where
    m1 = mask[:, None]
    zi = torch.zeros_like(cur["best_blk"])
    return dict(
        cur,
        o=where(m1, o_n, cur["o"]),
        d=where(m1, d_n, cur["d"]),
        t_cur=where(mask, t0_n, cur["t_cur"]),
        gate=where(mask, torch.full_like(cur["gate"], float(np.float32(gate_n))), cur["gate"]),
        maxt=where(mask, torch.full_like(cur["maxt"], _INF), cur["maxt"]),
        best_t=where(mask, torch.full_like(cur["best_t"], _INF), cur["best_t"]),
        best_blk=where(mask, zi, cur["best_blk"]),
        best_slot=where(mask, zi, cur["best_slot"]),
        cursor=where(mask, zi, cur["cursor"]),
        testing=cur["testing"] & ~mask,
        phase=where(mask, torch.full_like(cur["phase"], phase_n), cur["phase"]),
        lsteps=where(mask, zi, cur["lsteps"]),
        depth=where(mask, depth_n, cur["depth"]),
        alive=cur["alive"] | mask,
    )


class _WaveParams(ctypes.Structure):
    """Mirror of `WaveParams` in csrc/whitted_wave.cu (passed by value)."""

    _fields_ = [
        ("m", _MarchParams),
        ("li", ctypes.c_float), ("shadow_scale", ctypes.c_float),
        ("gate0", ctypes.c_float), ("gate_b", ctypes.c_float),
        ("eps", ctypes.c_float), ("smint", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("serial", ctypes.c_int), ("quirk", ctypes.c_int),
        ("max_bounces", ctypes.c_int), ("seg_bound", ctypes.c_int),
        ("n_faces", ctypes.c_int), ("n_mats", ctypes.c_int),
        ("pix_offset", ctypes.c_int), ("pix_stride", ctypes.c_int), ("n_pix", ctypes.c_int),
    ]


class _CameraParams(ctypes.Structure):
    """Mirror of `CameraParams` in csrc/camera.cuh (passed by value)."""

    _fields_ = [
        ("pos", ctypes.c_float * 3), ("u", ctypes.c_float * 3),
        ("v", ctypes.c_float * 3), ("w", ctypes.c_float * 3),
        ("fd", ctypes.c_float), ("aspect", ctypes.c_float),
        ("half_w", ctypes.c_float), ("half_h", ctypes.c_float),
        ("fw", ctypes.c_float), ("fh", ctypes.c_float), ("focus", ctypes.c_float),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("n_sub", ctypes.c_int), ("lens", ctypes.c_int),
    ]


def _launch_params(cam: CameraLaunch, consts: LaunchConsts, meta: PackedGridMeta, *,
                   n_slots: int, n_faces: int, n_mats: int, max_bounces: int, serial: bool,
                   gate0: float, gate_b: float, eps: float, smint: float, quirk: bool,
                   shadow_scale: float, bg, pix_offset: int = 0, pix_stride: int = 1,
                   queue_len: Optional[int] = None) -> "tuple[_WaveParams, _CameraParams]":
    """Kernel E's launch parameters, from host values only: a queue of
    queue_len positions (all the camera's subsamples by default), position
    k the subsample pix_offset + k * pix_stride."""
    n_pix = cam.camera.width * cam.camera.height * cam.spp * cam.spp
    n = n_pix if queue_len is None else queue_len
    seg_bound = _default_max_steps(meta)
    march = march_params(
        consts, meta, gate=gate0, shadow_gate=eps, shadow_mint=smint, n_slots=n_slots,
        fused=0, stop_on_first_hit=0, skip_dead=0, shade_serial=int(serial),
        serial_quirk=int(quirk), probe_chain=1, max_steps=int(seg_bound), n_rays=n, n_work=n)
    wave = _WaveParams(
        m=march, li=consts.intensity, shadow_scale=shadow_scale, gate0=gate0, gate_b=gate_b,
        eps=eps, smint=smint, bg=(ctypes.c_float * 3)(*(float(x) for x in bg)),
        serial=int(serial), quirk=int(quirk), max_bounces=int(max_bounces),
        seg_bound=int(seg_bound), n_faces=n_faces, n_mats=n_mats, pix_offset=int(pix_offset),
        pix_stride=int(pix_stride), n_pix=n_pix)
    pos, u, v, w = ((ctypes.c_float * 3)(*b) for b in cam.basis)
    fd, aspect, half_w, half_h, fw, fh, focus = cam.scalars
    camera = _CameraParams(
        pos=pos, u=u, v=v, w=w, fd=fd, aspect=aspect, half_w=half_w, half_h=half_h, fw=fw,
        fh=fh, focus=focus, width=cam.camera.width, height=cam.camera.height,
        n_sub=cam.spp * cam.spp, lens=int(cam.lens))
    return wave, camera


def whitted_wave_cuda(
    camera: CameraConfig, light_pos, light_intensity, mat9, tri9,
    grid: PackedGridArrays, meta: PackedGridMeta, *,
    max_bounces: int, serial: bool, spp: int = 1, gate0: float = 0.0, gate_b: float = 1e-4,
    eps: float = 1e-4, smint: float = 1e-4, quirk: bool = False,
    shadow_scale: float = 0.5, bg=(0.0, 0.0, 0.0),
    cam: Optional[CameraLaunch] = None, consts: Optional[LaunchConsts] = None,
    pix_offset: int = 0, pix_stride: int = 1, queue_len: Optional[int] = None,
    rays_out=None, capped_out=None, passes_out=None, tested_out=None, touched_out=None,
    slots_out=None, events_out=None, lanes_out=None,
) -> torch.Tensor:
    """Kernel E on CUDA tensors: the color of every queue position of
    `camera`'s H*W*spp^2 subsamples -> (R, 3) f32, the plain version's
    bits for the rays of `camera_rays(camera, spp=spp)`.  The sharded
    queue (spp 1): queue_len positions, position k the pixel pix_offset +
    k * pix_stride, a position past the last pixel dead (the background)
    -> (queue_len, 3), the plain version's bits for `queue_rays`.  A persistent
    wave of resident lanes pops the positions from a queue (a zeroed
    counter allocated here) and makes each position's camera ray itself;
    rays_out (R, 8) f32, when given, receives them (orig, dirn, mint,
    maxt).

    cam (`camera_launch(camera, spp)`) and consts (`launch_consts(grid,
    light_pos, light_intensity)`) are the launch's host-held values:
    given both, the call neither copies to nor from the device nor
    synchronises; each one missing is made here.  The counters are the
    plain version's (zeroed here, then filled by the launch); lanes_out
    (2,) int64, the kernel's own: its warps' loop iterations and the
    active lane-steps in them (lane utilisation = the second over 32
    times the first)."""
    if not grid.blocks.is_cuda:
        raise ValueError("whitted_wave_cuda takes CUDA tensors")
    dev = grid.blocks.device
    if cam is None:
        cam = camera_launch(camera, spp, device=dev)
    elif cam.camera != camera or cam.spp != spp:
        raise ValueError("cam was made for another camera or spp")
    if consts is None:
        consts = launch_consts(grid, light_pos, light_intensity)
    r = _queue_len(camera, spp, pix_offset, pix_stride, queue_len)
    blocks = grid.blocks.to(torch.float32).contiguous()
    cell_info = grid.cell_info.to(torch.int32).contiguous()
    slot_tri = grid.slot_tri.to(torch.int32).contiguous()
    tri9 = tri9.to(device=dev, dtype=torch.float32).contiguous()
    mat9 = mat9.to(device=dev, dtype=torch.float32).contiguous()
    table = cam.table.to(device=dev, dtype=torch.float32).contiguous()
    if blocks.shape != (meta.n_blocks, meta.row_lanes):
        raise ValueError("blocks does not match the meta")
    if tri9.ndim != 2 or tri9.shape[1] != 10 or mat9.ndim != 2 or mat9.shape[1] != 9:
        raise ValueError("tri9 must be (F, 10) and mat9 (M, 9)")
    if slot_tri.shape[0] >= (1 << 30):
        raise ValueError("slot index must fit in 30 bits")
    if r >= (1 << 31):
        raise ValueError("the queue's positions must fit in 31 bits")
    n_slots = slot_tri.shape[0]
    for name, buf, shape in (("capped_out", capped_out, (1,)), ("passes_out", passes_out, (1,)),
                             ("tested_out", tested_out, (r,)),
                             ("touched_out", touched_out, (meta.n_blocks,)),
                             ("slots_out", slots_out, (n_slots,)),
                             ("events_out", events_out, (len(EVENTS),))):
        _check_counter(name, buf, shape, dev)
    for name, buf, shape, dtype in (("lanes_out", lanes_out, (2,), torch.int64),
                                    ("rays_out", rays_out, (r, 8), torch.float32)):
        if buf is not None and (buf.dtype != dtype or tuple(buf.shape) != shape
                                or not buf.is_contiguous() or buf.device != dev):
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor on {dev}")
    for buf in (capped_out, passes_out, tested_out, touched_out, slots_out, events_out,
                lanes_out):
        if buf is not None:
            buf.zero_()
    color = torch.empty((r, 3), dtype=torch.float32, device=dev)
    if r == 0:
        return color
    head = torch.zeros((1,), dtype=torch.int32, device=dev)
    wave, cparams = _launch_params(
        cam, consts, meta, n_slots=n_slots, n_faces=tri9.shape[0], n_mats=mat9.shape[0],
        max_bounces=max_bounces, serial=serial, gate0=gate0, gate_b=gate_b, eps=eps,
        smint=smint, quirk=quirk, shadow_scale=shadow_scale, bg=bg, pix_offset=pix_offset,
        pix_stride=pix_stride, queue_len=r)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    fn = _build.library("whitted_wave").whitted_wave_launch
    fn.restype = ctypes.c_int
    p = ctypes.c_void_p
    fn.argtypes = [_WaveParams, _CameraParams] + [p] * 17
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(wave, cparams, table.data_ptr(), cell_info.data_ptr(), blocks.data_ptr(),
                 slot_tri.data_ptr(), tri9.data_ptr(), mat9.data_ptr(), color.data_ptr(),
                 ptr(rays_out), head.data_ptr(), ptr(capped_out), ptr(passes_out),
                 ptr(tested_out), ptr(touched_out), ptr(slots_out), ptr(events_out),
                 ptr(lanes_out), stream)
    _build.check(err, "whitted_wave")
    whitted_wave_cuda.launches += 1
    return color


whitted_wave_cuda.launches = 0


def _queue_len(camera: CameraConfig, spp: int, pix_offset: int, pix_stride: int,
               queue_len: Optional[int]) -> int:
    """The queue's length: every subsample unsharded, else queue_len
    (the JAX waves' sharded queue, which serves spp 1)."""
    n = camera.width * camera.height * spp * spp
    if pix_offset == 0 and pix_stride == 1 and queue_len in (None, n):
        return n
    if spp != 1:
        raise ValueError("the sharded wave queue serves spp == 1")
    if pix_offset < 0 or pix_stride < 1 or queue_len is None or queue_len < 0:
        raise ValueError("the sharded wave queue needs pix_offset >= 0, pix_stride >= 1 "
                         "and queue_len >= 0")
    if pix_offset + max(queue_len - 1, 0) * pix_stride >= (1 << 31):
        raise ValueError("the queue's pixel indices must fit in 31 bits")
    return queue_len


def whitted_wave_trace(
    light_pos, light_intensity, mat9, tri9, grid: PackedGridArrays, meta: PackedGridMeta, *,
    camera, max_bounces: int, serial: bool, spp: int = 1, wave: int = 12288, pump: int = 1,
    gate0: float = 0.0, gate_b: float = 1e-4, eps: float = 1e-4, smint: float = 1e-4,
    quirk: bool = False, shadow_scale: float = 0.5, bg=(0.0, 0.0, 0.0),
    refill_retries: int = 3, max_iters=None, pix_offset=None, pix_stride: int = 1,
    queue_len=None, tile: Optional[int] = None, cam: Optional[CameraLaunch] = None,
    consts: Optional[LaunchConsts] = None,
) -> torch.Tensor:
    """Whitted-shaded color per pixel -> (H*W, 3) f32, on grid's device.

    The queue holds the H*W*spp^2 camera subsamples (index s*H*W + pixel)
    and the subsample colors fold subsample-major after the trace.  On
    the card kernel E makes the camera rays itself (cam and consts, when
    given, are its host-held launch values); on the CPU the plain
    version traces the batch of `camera_rays`, `tile` positions at a time
    (each position is traced on its own, so the colors do not depend on
    it).  `wave`, `pump`, `refill_retries` and `max_iters` shape only the
    JAX lock-step loop and change no color.

    The sharded queue (spp 1; the JAX wave's): with pix_offset given,
    queue position k serves pixel pix_offset + k * pix_stride for k <
    queue_len, and the output is (queue_len, 3) in queue order, a position
    past the last pixel dead (the background); a shard of `render_sharded`
    serves its pixels so, each one's color the unsharded wave's."""
    del wave, pump, refill_retries, max_iters
    off = 0 if pix_offset is None else int(pix_offset)
    qn = _queue_len(camera, spp, off, int(pix_stride), queue_len)
    kw = dict(max_bounces=max_bounces, serial=serial, gate0=gate0, gate_b=gate_b, eps=eps,
              smint=smint, quirk=quirk, shadow_scale=shadow_scale, bg=tuple(bg))
    args = (light_pos, light_intensity, mat9, tri9, grid, meta)
    dev = grid.blocks.device
    if grid.blocks.is_cuda:
        col = whitted_wave_cuda(camera, *args, spp=spp, cam=cam, consts=consts,
                                pix_offset=off, pix_stride=int(pix_stride), queue_len=qn, **kw)
    elif dev.type == "cpu":
        if qn == camera.width * camera.height * spp * spp and off == 0 and pix_stride == 1:
            rays = camera_rays(camera, spp=spp, device=dev)
        else:
            rays = queue_rays(camera, off, int(pix_stride), qn, device=dev)
        col = rays.map_tiles(lambda rb: whitted_wave_plain(rb, *args, **kw),
                             rays.count if tile is None else tile)
    else:
        raise ValueError(f"unsupported device {dev}")
    if spp == 1:
        return col
    return fold_subsamples(col.reshape(spp * spp, camera.width * camera.height, 3))


__all__ = [
    "EVENTS", "build_wave_tables", "whitted_wave_cuda", "whitted_wave_plain",
    "whitted_wave_trace",
]
