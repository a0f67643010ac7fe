"""Ray-sharded renderers and traces, SPMD over the ranks of a mesh.

Counterpart of the ray half of `ray_tracer_tpu/parallel/shard.py`
(`stride_permutation`, `_pad_tris`, `render_sharded`,
`intersect_brute_sharded`, `trace_sharded`).  Every rank calls the same
function with the same arguments; each computes its shard on its own
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

Geometry sharded by ring orbits (`render_sharded_geometry`, the ring
train step, `trace_ring`) is the next slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.ops.camera import camera_rays
from ray_tracer_tpu_torch.ops.intersect import BruteResult, barycentric_pass, cramer_tbg
from ray_tracer_tpu_torch.parallel.collectives import all_gather, gather_image
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


__all__ = [
    "intersect_brute_sharded", "pad_rays", "render_sharded", "stride_permutation",
    "trace_sharded",
]
