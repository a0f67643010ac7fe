"""Sharded renderers and traces, SPMD over the ranks of a mesh.

Counterpart of `ray_tracer_tpu/parallel/shard.py`.  Every rank calls the
same function with the same arguments; each computes its shard on its own
device and the collectives (`parallel/collectives.py`) assemble the
result, which every rank gets whole, as the JAX package's global array.

  * **Ray sharding** (`render_sharded`, `trace_sharded`): the pixel or ray
    batch is padded to a multiple of the "rays" axis and dealt over it,
    round-robin (`stride_permutation`, the load balance) or in
    contiguous slices; geometry, grids and materials are replicated.  The
    cross-depth waves (kernels E and F) shard by queue arithmetic: a shard
    serves queue positions k of pixel offset + k * stride and makes their
    camera rays itself, so no ray batch is built or gathered.  Each pixel
    is computed whole on one rank with the unsharded arithmetic, so the
    image is the unsharded render's, bit for bit.
  * **Triangle sharding** (`intersect_brute_sharded`): the triangle soup
    is split over the "tris" axis, every shard intersects its rays with
    its slice, and per-ray nearest hits combine with an all-gather and a
    min that keeps the lowest triangle id on ties.
  * **Geometry sharded by ring orbits** (`intersect_ring_sharded`,
    `render_sharded_geometry`, `ring_loss`, `trace_ring`): each rank
    holds 1/D of the triangles (a contiguous slice over "tris") and, for
    the packed traversal, its own packed grid over that slice
    (`build_ring_shard`: each rank bins its own slice; `build_ring_grids`
    builds every shard's in one process, as the JAX package does).  Rays
    are dealt over both axes (the JAX package's P((rays, tris)):
    contiguous slices, flat shard index
    rays_index * Dt + tris_index), and each bundle orbits the "tris"
    axis in D hops of a local nearest hit (the shard's grid march,
    kernel C on the card, or the all-pairs Cramer sweep), a strict-better
    merge (smaller t, or equal t and the lower global id: independent of
    the visit order, so ids and ties are a replicated argmin's) and a
    shift to the next shard (`collectives.ring_pass`, one packed tensor a
    hop).  The winner comes home with its vertices, material and shading
    payload, from which `_ring_shade` shades, bounces and folds as the
    bounce loop does, and the path tracer runs on the `_RingTracer`.
    Under autograd the carried vertices' gradients travel back along the
    ring (`ring_pass`'s backward), so the ring train step
    (`opt.fit.make_ring_train_step`) keeps the vertex gradient of every
    shard's faces.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import Optional

from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.ops.camera import camera_rays
from ray_tracer_tpu_torch.ops.intersect import (
    BruteResult,
    barycentric_pass,
    cramer_bg_safe,
    cramer_t_safe,
    cramer_tbg,
)
from ray_tracer_tpu_torch.parallel.collectives import all_gather, gather_image, ring_pass
from ray_tracer_tpu_torch.parallel.mesh import axis_index, axis_size, make_mesh

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _pad_to(n: int, tile: int) -> int:
    return ((n + tile - 1) // tile) * tile


def pad_rays(rays: RayBatch, padded: int) -> RayBatch:
    """Pad a ray batch to `padded` rays with +inf origins (direction 1,
    mint 0, maxt 0): the grid's slab test drops them at entry."""
    r = rays.count
    if padded == r:
        return rays
    pad = padded - r

    def fill(x, v):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], v, dtype=x.dtype,
                                        device=x.device)])

    return RayBatch(fill(rays.orig, float("inf")), fill(rays.dirn, 1.0),
                    fill(rays.mint, 0.0), fill(rays.maxt, 0.0))


def stride_permutation(n: int, shards: int) -> np.ndarray:
    """Permutation that deals items round-robin to shards (and its use as
    an inverse gather): shard s gets items s, s+shards, s+2*shards, ...
    Interleaving pixels breaks up coherent empty-sky runs so per-shard
    work is statistically even."""
    idx = np.arange(n)
    return np.concatenate([idx[s::shards] for s in range(shards)])


def _pad_tris(v0, v1, v2, n_shards, fmat=None):
    """Pad the triangle soup to a multiple of n_shards with degenerate
    (all-zero) triangles, which never pass the strict barycentric test.
    Returns (v0, v1, v2, fmat padded or None, padded count)."""
    f = v0.shape[0]
    fp = _pad_to(f, n_shards)
    if fp != f:
        z = torch.zeros((fp - f, 3), dtype=v0.dtype, device=v0.device)
        v0, v1, v2 = (torch.cat([x, z]) for x in (v0, v1, v2))
        if fmat is not None:
            fmat = torch.cat([fmat, torch.zeros((fp - f,), dtype=fmat.dtype,
                                                device=fmat.device)])
    return v0, v1, v2, fmat, fp


class _Shards:
    """A frame's dealing of `r` items over `n` shards: padded to a multiple
    of n, shard s holding items offset + k * stride for k < local, the
    round-robin balance (offset s, stride n: `stride_permutation`) or
    contiguous slices (offset s*local, stride 1).  The index tensors are
    made on the device from arange arithmetic, once for a frame's shape."""

    _index = {}  # (r, n, s, balance, device) -> (this shard's items, inverse or None)

    def __init__(self, r: int, mesh, axis: str, balance: bool, device):
        self.r, self.mesh, self.axis = r, mesh, axis
        n = axis_size(mesh, axis)
        s = axis_index(mesh, axis)
        self.padded = _pad_to(r, n)
        self.local = self.padded // n
        self.offset, self.stride = (s, n) if balance else (s * self.local, 1)
        key = (r, n, s, bool(balance and n > 1), str(device))
        if key not in self._index:
            if len(self._index) >= 16:
                self._index.clear()
            k = torch.arange(self.local, device=device)
            items = self.offset + k * self.stride
            inv = None
            if key[3]:  # pixel i sits at (i mod n) * local + i // n of the gathered rows
                i = torch.arange(r, device=device)
                inv = (i % n) * self.local + torch.div(i, n, rounding_mode="floor")
            self._index[key] = (items, inv)
        self.items, self.inv = self._index[key]

    def mine(self, rays: RayBatch) -> RayBatch:
        """This shard's rays of a full batch."""
        rays = pad_rays(rays, self.padded)
        return RayBatch(*(x[self.items] for x in rays))

    def queue(self) -> dict:
        """This shard's wave queue (the JAX waves' pix_* arguments)."""
        return dict(pix_offset=self.offset, pix_stride=self.stride, queue_len=self.local)

    def assemble(self, colors: torch.Tensor) -> torch.Tensor:
        """Every shard's (local, C) rows -> the (r, C) image rows in pixel
        order, on every rank."""
        rows = gather_image(colors, self.mesh, self.axis)
        return rows[:self.r] if self.inv is None else rows[self.inv]


def render_sharded(prep, mesh=None, axis: str = "rays", balance: bool = True) -> torch.Tensor:
    """Render with pixels sharded over `axis` of `mesh` (every rank by
    default) -> (H, W, 3) on every rank, bitwise `render(prep)`.

    The branches and rules of the JAX function: the Whitted wave (kernel
    E) when the frame takes it at spp 1 without a lens; for gi_samples >
    0 the GI wave (kernel F) when `gi_wave_eligible`, else the segment
    integrator on each shard's rays; otherwise the bounce loop
    (`render_rays`: the persistent march, or a tile loop) on each shard's
    rays, spp subsamples accumulated in turn.  A sharded frame never takes
    the persistent march's camera refill (a shard's rays are not the
    camera's batch); gi_samples supersede spp; a transmissive scene needs
    gi_samples > 0."""
    from ray_tracer_tpu_torch.render.pathtrace import gi_wave_colors, pathtrace_rays
    from ray_tracer_tpu_torch.render.renderer import (
        accumulate_spp,
        render_rays,
        whitted_wave_colors,
    )

    cfg = prep.cfg
    rcfg = cfg.render
    if mesh is None:
        mesh = make_mesh(devices=prep.device)
    if rcfg.gi_samples == 0 and prep.scene.transmissive is not None:
        raise NotImplementedError(
            "transmissive (dielectric) materials are served by the "
            "path-traced integrator only — set render.gi_samples > 0")
    h, w = cfg.camera.height, cfg.camera.width
    dev = prep.device
    sh = _Shards(h * w, mesh, axis, balance, dev)
    setup = prep.frame()
    dtype = _DTYPES[rcfg.dtype]
    tile = max(1, rcfg.ray_tile)
    if rcfg.traversal == "packed":
        grid, meta = prep.packed.arrays, prep.packed.meta
    else:
        grid, meta = prep.grid.arrays, prep.grid.meta

    def shard_rays(rays: RayBatch, fn) -> torch.Tensor:
        mine = sh.mine(rays)
        return mine.map_tiles(fn, mine.count if dev.type == "cuda" else tile)

    with torch.no_grad():
        if rcfg.gi_samples > 0:
            if setup.gi_wave:
                colors = gi_wave_colors(prep, setup, **sh.queue())
            else:
                # sample keys hash the ray itself, not its batch index
                colors = shard_rays(
                    camera_rays(cfg.camera, dtype=dtype, device=dev),
                    lambda rb: pathtrace_rays(rb, prep.scene, grid, meta, cfg, dda=prep.dda,
                                              consts=setup.consts, vn=setup.vn))
            out = sh.assemble(colors)
        elif setup.wave and rcfg.spp == 1 and cfg.camera.aperture == 0.0:
            out = sh.assemble(whitted_wave_colors(prep, setup, **sh.queue()))
        else:
            def one(rays, camera_ok):
                del camera_ok  # a shard's rays are not the camera's batch
                return sh.assemble(shard_rays(
                    rays, lambda rb: render_rays(rb, prep.scene, grid, meta, rcfg,
                                                 dda=prep.dda, consts=setup.consts,
                                                 vn=setup.vn)))

            out = accumulate_spp(one, cfg.camera, rcfg.spp, dtype, dev)
    return out.reshape(h, w, 3)


# ---------------------------------------------------------------------------
# Triangle-sharded all-pairs intersection
# ---------------------------------------------------------------------------


def _local_best(rays: RayBatch, v0, v1, v2, tri_offset: int, t_lower, det_dtype):
    """Per-shard nearest hit over the local triangle slice -> (any pass,
    t in det_dtype, global id).  t stays in det_dtype through the
    cross-shard merge: a float32 cast here could make two distinct float64
    t's a tie and let the lowest-id rule pick another triangle than the
    replicated sweep's float64 argmin."""
    r, f = rays.count, v0.shape[0]
    dev = rays.orig.device
    best_t = torch.full((r,), float("inf"), dtype=det_dtype, device=dev)
    best_id = torch.zeros((r,), dtype=torch.int64, device=dev)
    any_pass = torch.zeros((r,), dtype=torch.bool, device=dev)
    o, d = rays.orig[:, None, :], rays.dirn[:, None, :]
    maxt = rays.maxt.to(det_dtype)[:, None]
    chunk = max(1, (1 << 22) // max(r, 1))
    for lo in range(0, f, chunk):
        hi = min(f, lo + chunk)
        t, beta, gamma = cramer_tbg(o, d, v0[None, lo:hi], v1[None, lo:hi], v2[None, lo:hi],
                                    det_dtype=det_dtype)
        passed = barycentric_pass(beta, gamma)
        accept = passed if t_lower is None else passed & (t > t_lower)
        # maxt bounds acceptance (inf for every render ray: no change there)
        accept = accept & (t <= maxt)
        any_pass |= passed.any(dim=1)
        t_masked = torch.where(accept, t, torch.full_like(t, float("inf")))
        j = torch.argmin(t_masked, dim=1)
        m = torch.gather(t_masked, 1, j[:, None])[:, 0]
        upd = m < best_t  # strict: the earlier chunk keeps a tie
        best_t = torch.where(upd, m, best_t)
        best_id = torch.where(upd, j + lo, best_id)
    return any_pass, best_t, (best_id + tri_offset).to(torch.int32)


def intersect_brute_sharded(rays: RayBatch, v0, v1, v2, mesh, rays_axis="rays",
                            tris_axis: str = "tris", t_lower=None,
                            det_dtype: str = "float32") -> BruteResult:
    """All-pairs nearest hit with triangles sharded over `tris_axis` (and
    rays over `rays_axis`, None to replicate them) -> BruteResult of every
    ray on every rank.  Padding triangles are degenerate and never pass;
    ids are global; equal t's resolve to the lowest id."""
    ddt = _DTYPES[det_dtype] if isinstance(det_dtype, str) else det_dtype
    f = v0.shape[0]
    n_tri = axis_size(mesh, tris_axis)
    it = axis_index(mesh, tris_axis)
    v0, v1, v2, _, fp = _pad_tris(v0, v1, v2, n_tri)
    per_tri = fp // n_tri
    n_ray = axis_size(mesh, rays_axis) if rays_axis else 1
    ir = axis_index(mesh, rays_axis) if rays_axis else 0
    r = rays.count
    rp = _pad_to(r, n_ray)
    per_ray = rp // n_ray
    mine = pad_rays(rays, rp).slice(ir * per_ray, (ir + 1) * per_ray)
    sl = slice(it * per_tri, (it + 1) * per_tri)
    any_p, t, tid = _local_best(mine, v0[sl], v1[sl], v2[sl], it * per_tri, t_lower, ddt)
    tris_group = mesh.get_group(tris_axis)
    ts = torch.stack(all_gather(t, tris_group))  # (S, R)
    ids = torch.stack(all_gather(tid, tris_group))
    anys = torch.stack(all_gather(any_p, tris_group))
    # argmin keeps the first minimum and shards hold ascending id ranges:
    # equal t's resolve to the lowest triangle id
    s_best = torch.argmin(ts, dim=0)
    t_best = torch.gather(ts, 0, s_best[None])[0]
    res = BruteResult(any_pass=anys.any(dim=0), t=t_best.to(torch.float32),
                      tri_id=torch.gather(ids, 0, s_best[None])[0],
                      hit=torch.isfinite(t_best))
    if rays_axis:
        res = BruteResult(*(gather_image(x, mesh, rays_axis) for x in res))
    res = BruteResult(*(x[:r] for x in res))
    return res._replace(tri_id=torch.where(res.hit, torch.clamp(res.tri_id, max=f - 1),
                                           res.tri_id))


# ---------------------------------------------------------------------------
# Ray-sharded trace queries (the AOV buffers and AO)
# ---------------------------------------------------------------------------


def trace_sharded(prep, rays: RayBatch, mesh, axis: str = "rays", t_gate: float = 1e-4,
                  stop_first: bool = False):
    """Trace an arbitrary ray batch with rays sharded over `axis` (geometry
    replicated) -> (hit, t, tri_id), (R,)-aligned on every rank and
    bitwise the single-device trace (kernel B or C on each rank's shard)."""
    from ray_tracer_tpu_torch.render.aov import _trace

    n = axis_size(mesh, axis)
    i = axis_index(mesh, axis)
    r = rays.count
    rp = _pad_to(r, n)
    per = rp // n
    mine = pad_rays(rays, rp).slice(i * per, (i + 1) * per)
    res = _trace(prep, mine, stop_on_first_hit=stop_first, gate=t_gate)
    hit, t, tid = (gather_image(x, mesh, axis)[:r] for x in (res.hit, res.t, res.tri_id))
    return hit, t, tid


# ---------------------------------------------------------------------------
# Geometry sharded by ring orbits
# ---------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1


def _check_ring_cfg(rcfg) -> None:
    """The ring renders production semantics only (the JAX package's
    `_check_ring_cfg`)."""
    if rcfg.faithful:
        raise ValueError("the ring renderer has production semantics only (faithful=False)")


def _shade_payload(j, extras) -> dict:
    """The per-face shading payload at the winner slot j: extras = (fvn
    (F,3,3) corner normals, fuv (F,3,2) corner uvs, fhuv (F,) has-uv
    flags), any of them None.  It rides the ring with the winning
    vertices."""
    fvn, fuv, fhuv = extras
    out = {}
    if fvn is not None:
        g = vm.take(fvn, j)
        out.update(vn0=g[:, 0], vn1=g[:, 1], vn2=g[:, 2])
    if fuv is not None:
        g = vm.take(fuv, j)
        out.update(uv0=g[:, 0], uv1=g[:, 1], uv2=g[:, 2], huv=vm.take(fhuv, j))
    return out


def _ring_local_best(rays: RayBatch, v0, v1, v2, fmat, tri_offset: int, t_lower, ddt,
                     extras=(None, None, None)) -> dict:
    """The all-pairs hop: the nearest accepted hit over this shard's
    triangles (the Cramer sweep with divides, accepted past t_lower and
    up to each ray's maxt) -> the winner's t in ddt, global id, material,
    vertices and payload, and `ap` (any barycentric pass).  Plain
    PyTorch, as the JAX package leaves it to XLA, chunked as `_local_best`
    (a strict < across chunks keeps argmin's first minimum)."""
    r, f = rays.count, v0.shape[0]
    dev = rays.orig.device
    best_t = torch.full((r,), float("inf"), dtype=ddt, device=dev)
    best_j = torch.zeros((r,), dtype=torch.int64, device=dev)
    ap = torch.zeros((r,), dtype=torch.bool, device=dev)
    o, d = rays.orig[:, None, :], rays.dirn[:, None, :]
    maxt = rays.maxt.to(ddt)[:, None]
    chunk = max(1, (1 << 22) // max(r, 1))
    for lo in range(0, f, chunk):
        hi = min(f, lo + chunk)
        # the sweep picks the topology only (its t is compared, never
        # differentiated): the carried vertices take the gradient
        t, beta, gamma = cramer_tbg(o, d, v0[None, lo:hi].detach(), v1[None, lo:hi].detach(),
                                    v2[None, lo:hi].detach(), det_dtype=ddt)
        passed = barycentric_pass(beta, gamma)
        accept = passed if t_lower is None else passed & (t > t_lower)
        accept = accept & (t <= maxt)
        ap |= passed.any(dim=1)
        t_masked = torch.where(accept, t, torch.full_like(t, float("inf")))
        j = torch.argmin(t_masked, dim=1)
        m = torch.gather(t_masked, 1, j[:, None])[:, 0]
        upd = m < best_t
        best_t = torch.where(upd, m, best_t)
        best_j = torch.where(upd, j + lo, best_j)
    return dict(t=best_t, tid=(best_j + tri_offset).to(torch.int32),
                mat=vm.take(fmat, best_j).to(torch.int32),
                tv0=vm.take(v0, best_j), tv1=vm.take(v1, best_j), tv2=vm.take(v2, best_j),
                ap=ap, **_shade_payload(best_j, extras))


def _grid_local_best(rays: RayBatch, my: int, garr, meta, v0, v1, v2, fmat, shard_tris: int,
                     t_gate, stop_first: bool, extras=(None, None, None), consts=None) -> dict:
    """The grid hop: this shard's packed-grid march (kernel C on the card)
    -> the winner's payload; the march's tri id is shard-local, clipped
    before the gathers and offset by my * shard_tris into the global
    id."""
    from ray_tracer_tpu_torch.ops.traverse_packed import traverse_packed

    res = traverse_packed(rays, garr, meta, t_gate=0.0 if t_gate is None else t_gate,
                          stop_on_first_hit=stop_first, consts=consts)
    j = torch.clamp(res.tri_id, 0, shard_tris - 1).long()
    return dict(t=torch.where(res.hit, res.t, torch.full_like(res.t, float("inf"))),
                tid=torch.where(res.hit, res.tri_id + my * shard_tris,
                                torch.full_like(res.tri_id, _INT32_MAX)),
                mat=vm.take(fmat, j).to(torch.int32),
                tv0=vm.take(v0, j), tv1=vm.take(v1, j), tv2=vm.take(v2, j),
                **_shade_payload(j, extras))


_DIFF_KEYS = ("tv0", "tv1", "tv2", "vn0", "vn1", "vn2")  # what carries gradients


def _ring_orbit(rays: RayBatch, local_best, mesh, tris_axis: str, t_dtype=torch.float32,
                with_any_pass: bool = False, smooth: bool = False, textured: bool = False):
    """Rays orbit the triangle shards: D hops of (local nearest hit ->
    strict-better merge -> shift to the next shard), after which every
    bundle is home with the global nearest hit.  The merge (t <, or t ==
    and the lower global id) does not depend on the visit order, so ids
    and ties are a replicated argmin's.  local_best(rays, my) is the hop
    (`_ring_local_best` or `_grid_local_best`); the best starts at t = inf
    and id INT32_MAX, as in the JAX package (whose zero payload is
    rays.orig * 0: NaN on lanes with inf origins).  -> (rays, best)."""
    nt = axis_size(mesh, tris_axis)
    my = axis_index(mesh, tris_axis)
    zf = (rays.mint * 0.0).to(torch.float32)
    zi = zf.to(torch.int32)
    z3 = (rays.orig * 0.0).to(torch.float32)
    best = dict(t=zf.to(t_dtype) + float("inf"), tid=torch.full_like(zi, _INT32_MAX), mat=zi,
                tv0=z3, tv1=z3, tv2=z3)
    if with_any_pass:
        best["ap"] = zi != 0
    if smooth:
        best.update(vn0=z3, vn1=z3, vn2=z3)
    if textured:
        z2 = z3[:, :2]
        best.update(uv0=z2, uv1=z2, uv2=z2, huv=zi != 0)
    side_keys = [k for k in best if k not in _DIFF_KEYS]
    diff_keys = [k for k in best if k in _DIFF_KEYS]
    for _ in range(nt):
        loc = local_best(rays, my)
        better = (loc["t"] < best["t"]) | ((loc["t"] == best["t"]) & (loc["tid"] < best["tid"]))
        best = {k: (best[k] | loc[k]) if k == "ap"
                else torch.where(better[:, None] if best[k].dim() == 2 else better,
                                 loc[k], best[k])
                for k in best}
        # every hop shifts, so hop D lands the bundle back home
        side, diff = ring_pass(list(rays) + [best[k] for k in side_keys],
                               [best[k] for k in diff_keys], mesh, tris_axis)
        rays = RayBatch(*side[:4])
        best = dict(zip(side_keys, side[4:]), **dict(zip(diff_keys, diff)))
    return rays, best


def _ring_shade(rays: RayBatch, orbit, rcfg, materials, light_pos, light_intensity,
                tex_image=None, env_image=None, textured=None, extra_light_pos=None,
                extra_light_intensity=None) -> torch.Tensor:
    """The ring renderer's integrator (the JAX package's `_ring_shade`):
    per depth one path orbit and one shadow orbit a light (or an area
    light's samples), shaded, blended by km and folded deepest-first as
    the bounce loop does.  orbit(rays, t_gate, stop_first) -> (rays,
    best).  The orbits run on detached rays; t, normals and shading are
    recomputed from the carried vertices, so the result is
    differentiable in the vertices, materials and light.  Misses carry
    the substitute triangle (e_x, e_y) so that no NaN reaches the
    backward pass."""
    from ray_tracer_tpu_torch.models.scenes import sample_env_image, texture_factor
    from ray_tracer_tpu_torch.ops.shade import (
        apply_shadow,
        hit_geometry_parallel,
        hit_geometry_serial,
        light_sample_offsets,
        shade_direct_parallel,
        shade_direct_serial,
        shade_parallel,
        shade_serial,
    )
    from ray_tracer_tpu_torch.render.renderer import _detached, shadow_rays_for

    smooth = rcfg.normal_mode == "smooth"
    if textured is None:
        textured = rcfg.texture != "none"
    serial = rcfg.serial_shading
    ddt = _DTYPES[rcfg.det_dtype]
    eps = rcfg.shadow_eps
    f32 = torch.float32
    cur = rays
    inf3 = torch.full_like(rays.orig, float("inf"))
    locals_ = []
    for depth in range(rcfg.max_bounces + 1):
        gate = rcfg.primary_gate() if depth == 0 else rcfg.bounce_gate()
        cur_sg = _detached(cur)
        _, best = orbit(cur_sg, 0.0 if gate is None else gate, False)
        hit = torch.isfinite(best["t"])
        h3 = hit[:, None]
        zero = torch.zeros_like(best["tv0"])
        ex, ey = zero.clone(), zero.clone()
        ex[:, 0] = 1.0
        ey[:, 1] = 1.0
        tv0 = torch.where(h3, best["tv0"], zero)
        tv1 = torch.where(h3, best["tv1"], ex)
        tv2 = torch.where(h3, best["tv2"], ey)
        t_re = cramer_t_safe(cur_sg.orig, cur.dirn, tv0, tv1, tv2, hit, det_dtype=ddt)
        t = torch.where(hit, t_re.to(f32), torch.zeros_like(t_re, dtype=f32))
        orig_safe = torch.where(h3, cur.orig, torch.zeros_like(cur.orig))
        if serial:
            geom = hit_geometry_serial(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        else:
            geom = hit_geometry_parallel(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        geom = geom._replace(poi=torch.where(h3, geom.poi, torch.zeros_like(geom.poi)))
        mat = materials.gather(best["mat"].long())
        if smooth or textured:
            hb, hg = cramer_bg_safe(cur_sg.orig, cur.dirn, tv0, tv1, tv2, hit, det_dtype=ddt)
            hb, hg = hb.to(f32), hg.to(f32)
            alpha = 1.0 - hb - hg
        if textured:
            if "uv0" not in best:
                raise NotImplementedError("this ring entry point does not carry uv payload")
            uv = (alpha[:, None] * best["uv0"] + hb[:, None] * best["uv1"]
                  + hg[:, None] * best["uv2"])
            tex = texture_factor(uv, best["huv"], hit, rcfg.texture, rcfg.texture_scale,
                                 tex_image, mat.base_color.dtype)
            mat = mat._replace(base_color=mat.base_color * tex.to(mat.base_color.dtype))
        if smooth:
            if "vn0" not in best:
                raise NotImplementedError("this ring entry point does not carry normal payload")
            sn = (alpha[:, None] * best["vn0"] + hb[:, None] * best["vn1"]
                  + hg[:, None] * best["vn2"])
            e_x = torch.zeros_like(sn)
            e_x[:, 0] = 1.0
            unit = vm.normalize(torch.where(h3, sn, e_x))
            geom = geom._replace(normal=torch.where(h3, unit * vm.length(geom.normal)[:, None],
                                                    geom.normal))

        def one_shadow(lp):
            """One occlusion orbit toward lp (any-hit hops): bool, or with
            soft visibility the sigmoid of the carried blocker's
            barycentric margin."""
            srays = _detached(shadow_rays_for(rcfg, lp, geom.poi, hit))
            _, sbest = orbit(srays, eps, True)
            s_hit = torch.isfinite(sbest["t"])
            occ = s_hit & hit
            if rcfg.soft_visibility <= 0.0:
                return occ
            sbeta, sgamma = cramer_bg_safe(srays.orig, srays.dirn, sbest["tv0"], sbest["tv1"],
                                           sbest["tv2"], s_hit, det_dtype=ddt)
            margin = torch.minimum(torch.minimum(sbeta, sgamma), 1.0 - sbeta - sgamma).to(f32)
            fs = vm.sigmoid(vm.div_scalar(margin, rcfg.soft_visibility))
            return torch.where(occ, fs, torch.zeros_like(fs))

        def occlusion_toward(lp):
            """Hard occlusion, or the mean over the area light's fixed
            sample set, one orbit a sample, added in sample order."""
            if not (rcfg.shadow_samples > 1 and rcfg.light_radius > 0.0):
                return one_shadow(lp)
            occ = torch.zeros(hit.shape, dtype=f32, device=hit.device)
            for off in light_sample_offsets(rcfg.shadow_samples, rcfg.light_radius):
                occ = occ + one_shadow(lp + torch.as_tensor(off, dtype=geom.poi.dtype,
                                                            device=hit.device)).to(f32)
            return vm.div_scalar(occ, float(rcfg.shadow_samples))

        in_shadow = occlusion_toward(light_pos)
        if serial:
            color = shade_serial(geom, mat, light_pos, light_intensity, in_shadow,
                                 rcfg.shadow_scale)
        else:
            color = shade_parallel(geom, mat, light_pos, in_shadow, rcfg.shadow_scale)
        if extra_light_pos is not None:
            for i in range(extra_light_pos.shape[0]):
                lp, li = extra_light_pos[i], extra_light_intensity[i]
                occ_i = occlusion_toward(lp)
                if serial:
                    direct = shade_direct_serial(geom, mat, lp, li)
                else:
                    direct = shade_direct_parallel(geom, mat, lp) * li
                color = color + apply_shadow(direct, occ_i, rcfg.shadow_scale)
        bg = torch.tensor(rcfg.background, dtype=color.dtype, device=color.device)
        if env_image is not None:
            bg = sample_env_image(env_image, vm.normalize(cur.dirn)).to(color.dtype)
        if rcfg.soft_primary > 0.0:
            if smooth or textured:
                phb, phg = hb, hg
            else:
                phb, phg = cramer_bg_safe(orig_safe, cur.dirn, tv0, tv1, tv2, hit, det_dtype=ddt)
                phb, phg = phb.to(f32), phg.to(f32)
            hm = torch.minimum(torch.minimum(phb, phg), 1.0 - phb - phg)
            hmargin = torch.maximum(hm, torch.zeros_like(hm)).to(color.dtype)
            fh = vm.tanh(vm.div_scalar(hmargin, rcfg.soft_primary))[:, None]
            color = fh * color + (1.0 - fh) * bg
        reflecting = hit & mat.reflective & (depth < rcfg.max_bounces)
        local = torch.where(reflecting[:, None],
                            color * mat.base_color * (1.0 - mat.km)[:, None],
                            torch.where(h3, color, bg))
        locals_.append((local, torch.where(reflecting, mat.km,
                                           torch.zeros_like(mat.km))[:, None]))
        if depth == rcfg.max_bounces:
            break
        rdir = vm.normalize(vm.reflect(vm.normalize(cur.dirn), vm.normalize(geom.normal)))
        rorig = torch.where(reflecting[:, None], geom.poi, inf3)
        cur = RayBatch.make(rorig, rdir, mint=eps)
    result = locals_[-1][0]
    for local, km in reversed(locals_[:-1]):
        result = local + km * result
    return result


class _RingDeal:
    """A ray batch of `r` rays dealt over both axes of a ring mesh, as the
    JAX package's P((rays, tris)): padded to a multiple of Dr * Dt, shard
    rays_index * Dt + tris_index holding a contiguous slice; `gather`
    assembles the shards' rows in that order (over "tris", then "rays")."""

    def __init__(self, r: int, mesh, rays_axis: Optional[str], tris_axis: str):
        self.r, self.mesh, self.rays_axis, self.tris_axis = r, mesh, rays_axis, tris_axis
        nt, it = axis_size(mesh, tris_axis), axis_index(mesh, tris_axis)
        nr = axis_size(mesh, rays_axis) if rays_axis else 1
        ir = axis_index(mesh, rays_axis) if rays_axis else 0
        self.shards = nt * nr
        self.padded = _pad_to(r, self.shards)
        self.per = self.padded // self.shards
        self.lo = (ir * nt + it) * self.per

    def mine(self, rays: RayBatch) -> RayBatch:
        return pad_rays(rays, self.padded).slice(self.lo, self.lo + self.per)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        x = gather_image(x, self.mesh, self.tris_axis)
        if self.rays_axis:
            x = gather_image(x, self.mesh, self.rays_axis)
        return x[:self.r]


class RingGrids:
    """Ring grids (the JAX package's `build_ring_grids` triple as
    attributes): `arrays`, packed grids stacked on a leading axis (host
    tensors over the host build) of shards first, first + 1, ...; `meta`,
    shared by every shard of the ring; `fp`, the padded face count.
    `shard(d, device)` puts shard d's grid on a device once and gives
    kernel C's launch values from the host copies."""

    def __init__(self, arrays, meta, fp: int, first: int = 0):
        self.arrays, self.meta, self.fp, self.first = arrays, meta, fp, first
        self._on_device = {}

    def shard(self, d: int, device):
        """(shard d's PackedGridArrays on `device`, its LaunchConsts)."""
        from ray_tracer_tpu_torch.accel.packed import PackedGridArrays
        from ray_tracer_tpu_torch.ops.traverse_packed import LaunchConsts

        k = d - self.first
        if not 0 <= k < self.arrays.blocks.shape[0]:
            raise ValueError(f"these ring grids hold no shard {d}")
        key = (d, str(device))
        if key not in self._on_device:
            a = self.arrays
            garr = PackedGridArrays(*(x[k].to(device).contiguous() for x in a))

            def vec(x):
                return tuple(float(v) for v in x[k].tolist())

            consts = LaunchConsts(lower=vec(a.lower), upper=vec(a.upper), width=vec(a.width),
                                  inv_width=vec(a.inv_width))
            self._on_device[key] = (garr, consts)
        return self._on_device[key]


def _ring_faces(scene, n_shards: int):
    """The faces and material ids padded to a multiple of n_shards, the
    padding faces point triangles at vertex 0 (material 0) -> (faces,
    fmat)."""
    faces, fmat = scene.faces, scene.face_material
    pad = _pad_to(faces.shape[0], n_shards) - faces.shape[0]
    if pad:
        faces = torch.cat([faces, torch.zeros((pad, 3), dtype=faces.dtype, device=faces.device)])
        fmat = torch.cat([fmat, torch.zeros((pad,), dtype=fmat.dtype, device=fmat.device)])
    return faces, fmat


def _ring_packs(prep, n_shards: int, shards) -> tuple:
    """The packed grids of the listed face slices in numpy: each slice
    binned at the replicated build's resolution on the scene's device
    (kernels H and G on the card), in the blocks layout (inline=False)
    whatever prep's layout -> (packs, fp)."""
    from ray_tracer_tpu_torch.accel.grid import build_grid
    from ray_tracer_tpu_torch.accel.packed import pack_grid
    from ray_tracer_tpu_torch.models.scenes import host_geometry

    verts_np, _ = host_geometry(prep.scene)
    faces_np = _ring_faces(prep.scene, n_shards)[0].cpu().numpy().astype(np.int32)
    fp = faces_np.shape[0]
    st = fp // n_shards
    rcfg = prep.cfg.render
    bt = prep.packed.meta.block_tris if prep.packed is not None else rcfg.packed_block_tris
    if bt <= 0:
        raise ValueError("packed_block_tris unresolved (prepare with traversal='packed')")
    res = tuple(int(n) for n in prep.grid.meta.n_voxels)
    packs = []
    for d in shards:
        sl = faces_np[d * st:(d + 1) * st]
        g = build_grid(verts_np, sl, force_resolution=res, device=prep.scene.verts.device,
                       resolution_multiplier=rcfg.grid.resolution_multiplier,
                       max_resolution=rcfg.grid.max_resolution,
                       exact_overlap=rcfg.grid.exact_overlap)
        packs.append(pack_grid(g, verts_np, sl, block_tris=bt, as_numpy=True,
                               leap=rcfg.grid.leap))
    return packs, fp


def _stack_ring(packs, sizes, fp: int, first: int) -> RingGrids:
    """RingGrids of `packs` under the meta that `sizes`, every shard's
    (n_blocks, probe_delta, max_blocks), share: the block count padded to
    the largest (zero rows, slot_tri -1), probe_delta the smallest,
    max_blocks the largest."""
    from ray_tracer_tpu_torch.accel.packed import PackedGridArrays, PackedGridMeta

    m0 = packs[0].meta
    nb = max(int(s[0]) for s in sizes)
    meta = PackedGridMeta(n_voxels=tuple(int(n) for n in m0.n_voxels), n_blocks=nb,
                          probe_delta=min(float(s[1]) for s in sizes),
                          block_tris=int(m0.block_tris), row_lanes=int(m0.row_lanes),
                          max_blocks=max(int(s[2]) for s in sizes))

    def padded(p):
        extra = nb - p.meta.n_blocks
        blocks, slot_tri = p.arrays.blocks, p.arrays.slot_tri
        if extra:
            blocks = np.concatenate([blocks, np.zeros((extra, meta.row_lanes), np.float32)])
            slot_tri = np.concatenate([slot_tri, np.full((extra * meta.block_tris,), -1,
                                                         np.int32)])
        return blocks, slot_tri

    rows = [padded(p) for p in packs]

    def stack(xs):
        return torch.from_numpy(np.stack(xs))

    arrays = PackedGridArrays(
        lower=stack([p.arrays.lower for p in packs]), upper=stack([p.arrays.upper for p in packs]),
        width=stack([p.arrays.width for p in packs]),
        inv_width=stack([p.arrays.inv_width for p in packs]),
        cell_info=stack([p.arrays.cell_info for p in packs]),
        blocks=stack([b for b, _ in rows]), slot_tri=stack([s for _, s in rows]))
    return RingGrids(arrays, meta, fp, first)


def _sizes(p) -> tuple:
    return (p.meta.n_blocks, p.meta.probe_delta, p.meta.max_blocks)


def build_ring_grids(prep, n_shards: int) -> RingGrids:
    """One packed grid a contiguous face slice, built on the scene's
    device and kept on the host (the JAX package's `build_ring_grids`,
    every shard's grid in this process):
    every slice binned at the replicated build's resolution, in the blocks
    layout (inline=False) whatever prep's layout; the meta shared (block
    count padded to the largest, probe_delta the smallest, max_blocks the
    largest), padded rows zero and their slot_tri -1; padding faces are
    point triangles at vertex 0.  Byte-equal to the JAX package's
    arrays."""
    packs, fp = _ring_packs(prep, n_shards, range(n_shards))
    return _stack_ring(packs, [_sizes(p) for p in packs], fp, 0)


def build_ring_shard(prep, mesh, tris_axis: str = "tris") -> RingGrids:
    """This rank's ring grid alone: its own face slice of the "tris" axis
    packed, the three meta sizes shared over the axis by one all-gather.
    Its shard is byte-equal to `build_ring_grids`', and each rank bins
    1/D of the faces (what the ring's entry points build when they are
    given no ring grids)."""
    nt, it = axis_size(mesh, tris_axis), axis_index(mesh, tris_axis)
    packs, fp = _ring_packs(prep, nt, [it])
    mine = torch.tensor(_sizes(packs[0]), dtype=torch.float64, device=prep.scene.verts.device)
    sizes = [s.tolist() for s in all_gather(mine, mesh.get_group(tris_axis))]
    return _stack_ring(packs, sizes, fp, it)


def _ring_extras(prep, faces, sl):
    """This shard's per-face shading payload (corner normals with smooth
    normals, corner uvs and has-uv flags with a texture) -> (fvn, fuv,
    fhuv), each None when the frame does not use it; padding faces carry
    zeros."""
    rcfg, scene = prep.cfg.render, prep.scene
    fp, nf = faces.shape[0], scene.num_faces
    fvn = fuv = fhuv = None

    def pad(x):
        return torch.cat([x, torch.zeros((fp - nf,) + x.shape[1:], dtype=x.dtype,
                                         device=x.device)])[sl]

    if rcfg.normal_mode == "smooth":
        # the path tracer interpolates the parallel convention's normals,
        # the Whitted ring the shading variant's
        vn = prep.frame().vn
        fvn = pad(vm.take(vn, scene.faces.reshape(-1)).reshape(nf, 3, 3).to(scene.verts.dtype))
    if rcfg.texture != "none" and scene.uvs is not None:
        uvf = torch.clamp(scene.uv_faces, min=0)
        fuv = pad(vm.take(scene.uvs, uvf.reshape(-1)).reshape(nf, 3, 2).to(scene.verts.dtype))
        fhuv = pad(scene.uv_faces[:, 0] >= 0)
    return fvn, fuv, fhuv


class _Ring:
    """A rank's ring: its triangle slice of the padded faces (vertices
    gathered from `verts`, which may be differentiable, and material ids),
    the slice's shading payload, and the orbit over grid hops (its
    shard's packed grid) or all-pairs hops."""

    def __init__(self, rcfg, mesh, tris_axis: str, verts, faces, fmat, ring_grids=None,
                 extras=(None, None, None)):
        self.mesh, self.tris_axis = mesh, tris_axis
        self.ddt = _DTYPES[rcfg.det_dtype]
        nt, it = axis_size(mesh, tris_axis), axis_index(mesh, tris_axis)
        st = faces.shape[0] // nt
        self.shard_tris = st
        fl = faces[it * st:(it + 1) * st]
        self.v0, self.v1, self.v2 = (vm.take(verts, fl[:, k]) for k in range(3))
        self.fmat = fmat[it * st:(it + 1) * st]
        self.extras = extras
        self.smooth, self.textured = extras[0] is not None, extras[1] is not None
        self.grid = None
        if ring_grids is not None:
            if ring_grids.fp != faces.shape[0]:
                raise ValueError("ring_grids were built for a different shard count")
            garr, consts = ring_grids.shard(it, verts.device)
            self.grid = (garr, ring_grids.meta, consts)

    @classmethod
    def of(cls, prep, mesh, tris_axis: str, ring_grids=None, features: bool = True):
        """The ring of a prepared frame: grid hops for the packed traversal
        (`build_ring_shard` when no ring grids are given), the shading
        payload unless features=False."""
        rcfg = prep.cfg.render
        nt, it = axis_size(mesh, tris_axis), axis_index(mesh, tris_axis)
        faces, fmat = _ring_faces(prep.scene, nt)
        if rcfg.traversal != "packed":
            ring_grids = None
        elif ring_grids is None:
            ring_grids = build_ring_shard(prep, mesh, tris_axis)
        st = faces.shape[0] // nt
        extras = (_ring_extras(prep, faces, slice(it * st, (it + 1) * st)) if features
                  else (None, None, None))
        return cls(rcfg, mesh, tris_axis, prep.scene.verts, faces, fmat, ring_grids, extras)

    def orbit(self, rb: RayBatch, t_gate, stop_first: bool, with_any_pass: bool = False):
        """One orbit of rb (any hit when stop_first, which carries no
        shading payload) -> (rays, best)."""
        ex = (None, None, None) if stop_first else self.extras
        carry = dict(smooth=self.smooth and not stop_first,
                     textured=self.textured and not stop_first)
        st = self.shard_tris
        if self.grid is not None:
            garr, meta, consts = self.grid
            return _ring_orbit(
                rb, lambda r_, my: _grid_local_best(r_, my, garr, meta, self.v0, self.v1,
                                                    self.v2, self.fmat, st, t_gate, stop_first,
                                                    extras=ex, consts=consts),
                self.mesh, self.tris_axis, **carry)
        return _ring_orbit(
            rb, lambda r_, my: _ring_local_best(r_, self.v0, self.v1, self.v2, self.fmat,
                                                my * st, t_gate, self.ddt, extras=ex),
            self.mesh, self.tris_axis, t_dtype=self.ddt, with_any_pass=with_any_pass, **carry)


def intersect_ring_sharded(rays: RayBatch, v0, v1, v2, mesh, rays_axis: Optional[str] = "rays",
                           tris_axis: str = "tris", t_lower=None,
                           det_dtype: str = "float32") -> BruteResult:
    """All-pairs nearest hit with the triangles sharded over `tris_axis`
    and the rays ring-passed between neighbours (the JAX package's
    `intersect_ring_sharded`) -> BruteResult of every ray on every rank:
    ids and ties exactly the replicated sweep's, t from the same Cramer
    arithmetic, any_pass OR-ed over the hops."""
    ddt = _DTYPES[det_dtype] if isinstance(det_dtype, str) else det_dtype
    f = v0.shape[0]
    nt, it = axis_size(mesh, tris_axis), axis_index(mesh, tris_axis)
    v0, v1, v2, _, fp = _pad_tris(v0, v1, v2, nt)
    st = fp // nt
    sl = slice(it * st, (it + 1) * st)
    fmat = torch.zeros((st,), dtype=torch.int32, device=v0.device)
    deal = _RingDeal(rays.count, mesh, rays_axis, tris_axis)
    _, best = _ring_orbit(
        deal.mine(rays),
        lambda r_, my: _ring_local_best(r_, v0[sl], v1[sl], v2[sl], fmat, my * st, t_lower, ddt),
        mesh, tris_axis, t_dtype=ddt, with_any_pass=True)
    hit = torch.isfinite(best["t"])
    res = BruteResult(any_pass=best["ap"], t=best["t"].to(torch.float32),
                      tri_id=torch.where(hit, best["tid"], torch.full_like(best["tid"], -1)),
                      hit=hit)
    res = BruteResult(*(deal.gather(x) for x in res))
    return res._replace(tri_id=torch.where(res.hit, torch.clamp(res.tri_id, max=f - 1),
                                           res.tri_id))


def _ring_mesh(prep, mesh, rays_axis):
    """mesh=None: every rank on one "tris" axis (rays dealt over it alone)."""
    if mesh is None:
        return make_mesh(axis_names=("tris",), devices=prep.device), None
    return mesh, rays_axis


def render_sharded_geometry(prep, mesh=None, rays_axis: Optional[str] = "rays",
                            tris_axis: str = "tris", ring_grids=None) -> torch.Tensor:
    """Render with the geometry sharded over `tris_axis` and the rays
    ring-passed (the JAX package's `render_sharded_geometry`) -> (H, W, 3)
    on every rank.  Each rank holds 1/D of the triangles; each depth's path
    and shadow rays orbit the ring once.  traversal="packed" hops march
    each shard's own packed grid (kernel C on the card; ring_grids from
    `build_ring_shard` or `build_ring_grids`, this rank's alone built here
    when not given), other traversals take the all-pairs hop.
    gi_samples > 0 path-traces through the ring tracer (the segment
    integrator; gi_samples supersede spp), else the Whitted ring with spp
    subsamples accumulated in turn.  The image matches the replicated
    render up to last-ulp differences (per-shard grids may flip a ray on
    an edge two triangles share).  mesh=None: one "tris" axis over every
    rank."""
    mesh, rays_axis = _ring_mesh(prep, mesh, rays_axis)
    from ray_tracer_tpu_torch.render.renderer import accumulate_spp

    cfg, scene = prep.cfg, prep.scene
    rcfg = cfg.render
    _check_ring_cfg(rcfg)
    gi = rcfg.gi_samples > 0
    if scene.transmissive is not None and not gi:
        raise NotImplementedError(
            "transmissive (dielectric) materials are served by the "
            "path-traced integrator only — set render.gi_samples > 0")
    ring = _Ring.of(prep, mesh, tris_axis, ring_grids)
    h, w = cfg.camera.height, cfg.camera.width
    deal = _RingDeal(h * w, mesh, rays_axis, tris_axis)
    dtype, dev = _DTYPES[rcfg.dtype], prep.device
    if gi:
        body = _ring_pt_body(ring, cfg, scene)
    else:
        def body(mine):
            return _ring_shade(mine, ring.orbit, rcfg, scene.materials, scene.light_pos,
                               scene.light_intensity, tex_image=scene.texture_image,
                               env_image=scene.env_image, textured=ring.textured,
                               extra_light_pos=scene.extra_light_pos,
                               extra_light_intensity=scene.extra_light_intensity)

    def one(rays, _camera_ok):
        return deal.gather(body(deal.mine(rays)))

    with torch.no_grad():
        if gi:
            colors = one(camera_rays(cfg.camera, dtype=dtype, device=dev), False)
        else:
            colors = accumulate_spp(one, cfg.camera, rcfg.spp, dtype, dev)
    return colors.reshape(h, w, 3)


class _RingTracer:
    """The path tracer's `tracer` over ring orbits: each segment's nearest
    hit comes home with its vertices, material and shading payload, and
    occlusion queries are any-hit orbits."""

    def __init__(self, ring: "_Ring", eps: float):
        self.ring, self.eps = ring, eps
        self.carries = (("smooth",) if ring.smooth else ()) + (("uv",) if ring.textured else ())

    def trace(self, rb: RayBatch, t_gate):
        _, b = self.ring.orbit(rb, t_gate, False)
        payload = {k: b[k] for k in ("vn0", "vn1", "vn2", "uv0", "uv1", "uv2", "huv") if k in b}
        f32 = torch.float32
        return (torch.isfinite(b["t"]), b["tv0"].to(f32), b["tv1"].to(f32), b["tv2"].to(f32),
                b["mat"], payload)

    def occlude(self, rb: RayBatch) -> torch.Tensor:
        _, b = self.ring.orbit(rb, self.eps, True)
        return torch.isfinite(b["t"])


def ring_scene_stub(scene):
    """The geometry-free scene the path tracer sees under the ring tracer:
    the tracer carries the vertices, so only the shading and lighting
    tables are the scene's."""
    from ray_tracer_tpu_torch.models.scenes import Scene

    dev = scene.device
    return Scene(verts=torch.zeros((1, 3), dtype=torch.float32, device=dev),
                 faces=torch.zeros((1, 3), dtype=torch.int64, device=dev),
                 face_material=torch.zeros((1,), dtype=torch.int64, device=dev),
                 materials=scene.materials, light_pos=scene.light_pos,
                 light_intensity=scene.light_intensity, texture_image=scene.texture_image,
                 env_image=scene.env_image, extra_light_pos=scene.extra_light_pos,
                 extra_light_intensity=scene.extra_light_intensity,
                 transmissive=scene.transmissive, ior=scene.ior)


def _ring_pt_body(ring: "_Ring", cfg, scene):
    """Ring GI (the JAX package's `_ring_pt_fn`): the one segment integrator
    (`pathtrace_rays`) on the ring tracer and the geometry-free stub."""
    from ray_tracer_tpu_torch.render.pathtrace import pathtrace_rays

    tracer = _RingTracer(ring, cfg.render.shadow_eps)
    stub = ring_scene_stub(scene)
    return lambda mine: pathtrace_rays(mine, stub, None, None, cfg, tracer=tracer)


def ring_loss(params, faces, fmat, reflective, rays: RayBatch, target, cfg, mesh,
              rays_axis: Optional[str], tris_axis: str, ring_grids=None) -> torch.Tensor:
    """This rank's share of the differentiable ring loss (the JAX package's
    `ring_loss_fn` body before its psum): the sum of squared residuals
    over 255 of this rank's rays, with the vertices gathered from the
    replicated params.verts through this shard's faces (index_select),
    the orbits on detached rays, padding pixels masked by their inf
    origins, and at spp > 1 each pixel's pixel-major subsamples averaged.
    faces/fmat: the padded (fp, 3) faces and (fp,) material ids;
    ring_grids holding this rank's shard (`build_ring_shard` or
    `build_ring_grids`), None for all-pairs hops."""
    from ray_tracer_tpu_torch.models.materials import MaterialTable

    rcfg = cfg.render
    _check_ring_cfg(rcfg)
    materials = MaterialTable(base_color=params.base_color, kd=params.kd, ks=params.ks,
                              spec_alpha=params.spec_alpha, ka=params.ka, km=params.km,
                              reflective=reflective)
    ring = _Ring(rcfg, mesh, tris_axis, params.verts, faces, fmat, ring_grids)
    colors = _ring_shade(rays, ring.orbit, rcfg, materials, params.light_pos,
                         params.light_intensity)
    if rcfg.spp > 1:
        ss = rcfg.spp * rcfg.spp
        colors = colors.reshape(-1, ss, 3).mean(dim=1)
        po = rays.orig.reshape(-1, ss, 3)[:, 0, :]
    else:
        po = rays.orig
    d = vm.div_scalar(colors - target.to(colors.dtype), 255.0)
    d = torch.where(torch.isfinite(po[:, :1]), d, torch.zeros_like(d))
    return torch.sum(d * d)


def trace_ring(prep, rays: RayBatch, mesh, rays_axis: Optional[str] = "rays",
               tris_axis: str = "tris", t_gate: float = 1e-4, stop_first: bool = False,
               ring_grids=None) -> dict:
    """Trace an arbitrary ray batch over ring-sharded geometry (the JAX
    package's `trace_ring`) -> {hit, t, tri_id, mat, tv0, tv1, tv2},
    (R,)-aligned on every rank: one orbit (grid hops for the packed
    traversal, all-pairs otherwise), global ids, -1 and inf on misses."""
    _check_ring_cfg(prep.cfg.render)
    ring = _Ring.of(prep, mesh, tris_axis, ring_grids, features=False)
    deal = _RingDeal(rays.count, mesh, rays_axis, tris_axis)
    with torch.no_grad():
        _, b = ring.orbit(deal.mine(rays), float(t_gate), bool(stop_first))
        hit = torch.isfinite(b["t"])
        f32 = torch.float32
        out = dict(hit=hit, t=b["t"].to(f32),
                   tri_id=torch.where(hit, b["tid"], torch.full_like(b["tid"], -1)),
                   mat=torch.where(hit, b["mat"], torch.full_like(b["mat"], -1)),
                   tv0=b["tv0"].to(f32), tv1=b["tv1"].to(f32), tv2=b["tv2"].to(f32))
        return {k: deal.gather(v) for k, v in out.items()}


__all__ = [
    "RingGrids", "build_ring_grids", "build_ring_shard", "intersect_brute_sharded",
    "intersect_ring_sharded", "pad_rays", "render_sharded", "render_sharded_geometry", "ring_loss", "ring_scene_stub",
    "stride_permutation", "trace_ring", "trace_sharded",
]
