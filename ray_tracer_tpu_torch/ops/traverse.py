"""CSR uniform-grid 3D-DDA traversal: kernel B and its plain version.

Counterpart of `ray_tracer_tpu/ops/traverse.py` (`traverse_grid`,
`_dda_setup`), the port of the reference's per-ray PBRT grid walk
(Serial/grid.h:167-231) with its exact hit semantics:

  * `t_gate=None` accepts any barycentric pass as a hit, behind the
    origin too (the faithful serial primary regime,
    Serial/geometry.h:164-171); `t_gate=eps` gates t > eps;
  * `any_pass` is the reference's `hitSomething`: any pass in a walked
    voxel, whatever the gate (Serial/raytracer.cpp:110-112);
  * `early_exit` retires a ray once its record precedes the next voxel
    boundary, and `stop_on_first_hit` on any accepted hit;
  * the step axis comes from the LUT cmpToAxis = [2,1,2,1,2,2,0,0]
    (grid.h:217-221).

The rays may be float32 or float64 (dtype="float64"): the entry setup
and the DDA's crossings run in the rays' own type, the running minimum t
stays float32 and the Cramer solve takes the rays in the determinant
type, as in the JAX package.

`traverse_grid_cuda` launches `csrc/traverse_grid.cu`, one thread per
ray, over `DdaTables` derived from the CSR grid once (`dda_tables`: an
occupancy bit per cell, an (start, count) pair per cell, the vertices in
CSR order), which neither the JAX package nor the plain version uses.
`traverse_grid_plain` is the JAX package's lock-step loop in plain
PyTorch: the batch advances together, dead lanes frozen by masks, until
every lane is dead or nx+ny+nz+2 steps are done.  `traverse_grid` takes
the kernel for CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ray_tracer_tpu_torch.accel.grid import GridArrays, GridMeta
from ray_tracer_tpu_torch.core.aabb import AABB, slab_intersect
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.kernels import _build
from ray_tracer_tpu_torch.ops.intersect import barycentric_pass, cramer_tbg

_CMP_TO_AXIS = (2, 1, 2, 1, 2, 2, 0, 0)
_DET_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class TraceResult(NamedTuple):
    any_pass: torch.Tensor  # (R,) bool, the reference's 'hitSomething'
    hit: torch.Tensor  # (R,) bool, a nearest-hit record exists
    t: torch.Tensor  # (R,) f32 nearest accepted t
    tri_id: torch.Tensor  # (R,) i32 (-1 if no record)
    steps: torch.Tensor  # (R,) i32 voxels visited


def vertex_table(v0, v1, v2) -> torch.Tensor:
    """(F, 9) f32 rows v0 v1 v2, the kernel's per-triangle gather unit."""
    return torch.cat([v0, v1, v2], dim=1).to(torch.float32).contiguous()


class DdaTables(NamedTuple):
    """Kernel B's tables, derived from the CSR grid and the vertex table."""

    occupancy: torch.Tensor  # (ceil(n_cells / 32),) i32: bit c & 31 of
    #                          word c >> 5 = cell c holds a triangle
    cell_range: torch.Tensor  # (n_cells, 2) i32 (cell_start, count)
    cell_tri9: torch.Tensor  # (nnz, 9) f32 = tri9[tri_ids], CSR order


def dda_tables(grid: GridArrays, tri9: torch.Tensor) -> DdaTables:
    """Kernel B's tables on the grid's device: the occupancy mask of
    diff(cell_start) > 0, the (start, count) pair of every cell and the
    vertex rows in CSR order."""
    start = grid.cell_start.to(torch.int64)
    counts = start[1:] - start[:-1]
    n_cells = counts.shape[0]
    words = -(-n_cells // 32)
    occ = torch.zeros((words * 32,), dtype=torch.int64, device=counts.device)
    occ[:n_cells] = (counts > 0).to(torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=counts.device)
    packed = (occ.reshape(words, 32) << bits).sum(dim=1)
    packed = torch.where(packed >= (1 << 31), packed - (1 << 32), packed)  # as int32 bits
    cell_range = torch.stack([start[:-1], counts], dim=1).to(torch.int32).contiguous()
    cell_tri9 = tri9.to(torch.float32)[grid.tri_ids.long()].contiguous()
    return DdaTables(occupancy=packed.to(torch.int32), cell_range=cell_range,
                     cell_tri9=cell_tri9)


def _to_cell(pos_f: torch.Tensor, nvox: torch.Tensor) -> torch.Tensor:
    """f32 or f64 -> voxel index the way the JAX code's int32 cast then clip
    behaves: NaN -> 0, out-of-range values saturate, truncation toward
    zero, clip to [0, n-1].  (A C or PyTorch cast of NaN or inf is
    undefined or gives INT_MIN, so the saturation is written out.)"""
    p = torch.where(torch.isnan(pos_f), torch.zeros_like(pos_f), pos_f)
    p = torch.minimum(torch.clamp(p, min=-1.0), nvox.to(p.dtype))
    return torch.minimum(torch.clamp(p.to(torch.int32), min=0), nvox - 1)


def _dda_setup(rays: RayBatch, grid: GridArrays, n_voxels):
    """Grid entry and per-axis DDA state (Serial/grid.h:170-203)."""
    bounds = AABB(grid.lower, grid.upper)
    inside = bounds.inside(rays.at(rays.mint))
    slab_hit, t0, _ = slab_intersect(bounds, rays)
    ray_t = torch.where(inside, rays.mint, t0)
    alive = inside | slab_hit

    gi = rays.at(ray_t)  # (R,3) grid entry point
    nvox = torch.tensor(n_voxels, dtype=torch.int32, device=gi.device)
    pos = _to_cell((gi - grid.lower) * grid.inv_width, nvox)

    dir_nonneg = rays.dirn >= 0
    one = torch.ones_like(pos)
    step = torch.where(dir_nonneg, one, -one)
    out = torch.where(dir_nonneg, nvox.expand_as(pos), -one)
    # voxelToPos(p, axis) = lower + p * width (grid.h:68-71)
    next_boundary = grid.lower + torch.where(
        dir_nonneg, (pos + 1).to(gi.dtype), pos.to(gi.dtype)
    ) * grid.width
    next_crossing = ray_t[:, None] + (next_boundary - gi) / rays.dirn
    delta = torch.where(dir_nonneg, grid.width, -grid.width) / rays.dirn
    return alive, pos, next_crossing, delta, step, out


def traverse_grid_plain(
    rays: RayBatch, grid: GridArrays, meta: GridMeta, tri9: torch.Tensor, *,
    t_gate: Optional[float] = None, early_exit: bool = False,
    stop_on_first_hit: bool = False, det_dtype: str = "float32",
    tested_out: Optional[torch.Tensor] = None,
) -> TraceResult:
    """The lock-step masked loop of the JAX package, in plain PyTorch.
    tri9: (F, 9) f32 vertex table.  tested_out, when given, receives the
    number of triangles each ray tested."""
    nx, ny, nz = meta.n_voxels
    m_pad = max(meta.max_per_voxel, 1)
    nnz = max(meta.nnz, 1)
    ddt = _DET_DTYPES[det_dtype]
    max_steps = nx + ny + nz + 2
    dev = rays.orig.device
    r = rays.count

    alive, pos, next_crossing, delta, step, out = _dda_setup(rays, grid, meta.n_voxels)
    tri_ids = grid.tri_ids if meta.nnz > 0 else torch.zeros((1,), torch.int32, device=dev)
    v0, v1, v2 = tri9[:, 0:3], tri9[:, 3:6], tri9[:, 6:9]
    inf32 = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    j_idx = torch.arange(m_pad, dtype=torch.int32, device=dev)
    axes = torch.arange(3, dtype=torch.int64, device=dev)
    lut = torch.tensor(_CMP_TO_AXIS, dtype=torch.int64, device=dev)

    any_pass = torch.zeros((r,), dtype=torch.bool, device=dev)
    found = torch.zeros((r,), dtype=torch.bool, device=dev)
    t_min = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    steps = torch.zeros((r,), dtype=torch.int32, device=dev)
    tested = torch.zeros((r,), dtype=torch.int32, device=dev)

    i = 0
    while i < max_steps and bool(alive.any()):
        # ---- test every live ray's current voxel --------------------------
        xc = torch.clamp(pos[:, 0], 0, nx - 1)
        yc = torch.clamp(pos[:, 1], 0, ny - 1)
        zc = torch.clamp(pos[:, 2], 0, nz - 1)
        cell = (zc * (nx * ny) + yc * nx + xc).long()  # z-major (grid.h:73-75)
        start = grid.cell_start[cell]
        count = grid.cell_start[cell + 1] - start
        tested += torch.where(alive, count, torch.zeros_like(count))

        idx = torch.clamp(start[:, None] + j_idx[None, :], 0, nnz - 1).long()
        tri = tri_ids[idx]  # (R, M)
        valid = (j_idx[None, :] < count[:, None]) & alive[:, None]
        tl = tri.long()
        t, beta, gamma = cramer_tbg(
            rays.orig[:, None, :], rays.dirn[:, None, :],
            v0[tl], v1[tl], v2[tl], det_dtype=ddt,
        )
        passed = barycentric_pass(beta, gamma) & valid
        any_pass = any_pass | passed.any(dim=-1)

        cand = passed if t_gate is None else passed & (t > t_gate)
        t_masked = torch.where(cand, t, torch.full_like(t, float("inf")))
        j_best = torch.argmin(t_masked, dim=-1)  # first index on ties
        m = torch.gather(t_masked, 1, j_best[:, None])[:, 0]
        # cross-step compare in det precision against the f32 running min
        # (Serial/geometry.h:164-169)
        upd = m < t_min.to(ddt)
        t_min = torch.where(upd, m.to(torch.float32), t_min)
        best = torch.where(upd, torch.gather(tri, 1, j_best[:, None])[:, 0], best)
        found = found | upd

        # ---- advance to the next voxel (grid.h:214-228) -------------------
        n0, n1, n2 = next_crossing[:, 0], next_crossing[:, 1], next_crossing[:, 2]
        bits = 4 * (n0 < n1).long() + 2 * (n0 < n2).long() + (n1 < n2).long()
        step_axis = lut[bits]  # (R,)
        onehot = step_axis[:, None] == axes[None, :]
        ncr = torch.gather(next_crossing, 1, step_axis[:, None])[:, 0]

        maxt_eff = rays.maxt
        if early_exit:
            maxt_eff = torch.minimum(maxt_eff, torch.where(found, t_min, inf32))
        die_maxt = maxt_eff < ncr

        move = alive & ~die_maxt
        pos_new = pos + torch.where(onehot, step, torch.zeros_like(step))
        pos = torch.where(move[:, None], pos_new, pos)
        hit_edge = torch.gather(pos == out, 1, step_axis[:, None])[:, 0]
        die_out = move & hit_edge
        next_crossing = torch.where(
            move[:, None],
            next_crossing + torch.where(onehot, delta, torch.zeros_like(delta)),
            next_crossing,
        )

        steps = steps + alive.to(torch.int32)  # lanes alive before the advance
        alive = move & ~die_out
        if stop_on_first_hit:
            alive = alive & ~found
        i += 1
    if tested_out is not None:
        tested_out.copy_(tested)
    return TraceResult(any_pass=any_pass, hit=found, t=t_min, tri_id=best, steps=steps)


def traverse_grid_cuda(
    rays: RayBatch, grid: GridArrays, meta: GridMeta, tri9: torch.Tensor, *,
    t_gate: Optional[float] = None, early_exit: bool = False,
    stop_on_first_hit: bool = False, det_dtype: str = "float32",
    tested_out: Optional[torch.Tensor] = None, tables: Optional[DdaTables] = None,
    passes_out: Optional[torch.Tensor] = None,
) -> TraceResult:
    """Kernel B on CUDA tensors; the same outputs as the plain version.
    Float64 rays launch the f64-ray instantiations (the DDA in float64, as
    the plain version runs it on them), float32 rays the others.
    `tables` are `dda_tables(grid, tri9)`, built here when not given.
    passes_out (1,) i32, when given, receives the number of tested
    triangles that passed the barycentric test (chip_smoke.py counts the
    operation bound from it)."""
    if not rays.orig.is_cuda:
        raise ValueError("traverse_grid_cuda takes CUDA tensors")
    if det_dtype not in _DET_DTYPES:
        raise ValueError(f"unknown det_dtype {det_dtype!r}")
    dev = rays.orig.device
    # the rays' own type, float32 or float64 (the f64-ray instantiations);
    # mixed fields promote as XLA's arithmetic would
    ray_dtype = torch.float32
    for x in rays:
        ray_dtype = torch.promote_types(ray_dtype, x.dtype)
    if ray_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rays must be float32 or float64, not {ray_dtype}")
    orig, dirn, mint, maxt = (x.to(ray_dtype).contiguous() for x in rays)
    if tables is None:
        tables = dda_tables(grid, tri9)
    occupancy = tables.occupancy.to(torch.int32).contiguous()
    cell_range = tables.cell_range.to(torch.int32).contiguous()
    cell_tri9 = tables.cell_tri9.to(torch.float32).contiguous()
    nx, ny, nz = meta.n_voxels
    if (occupancy.numel() * 32 < nx * ny * nz or cell_range.shape != (nx * ny * nz, 2)
            or cell_tri9.shape != (meta.nnz, 9)):
        raise ValueError("tables do not match the grid")
    gridf = torch.cat([grid.lower, grid.upper, grid.width, grid.inv_width]).to(
        torch.float32).contiguous()
    tri_ids = grid.tri_ids.to(torch.int32).contiguous()
    if tri_ids.numel() == 0:
        tri_ids = torch.zeros((1,), dtype=torch.int32, device=dev)
    for name, buf, shape in (("tested_out", tested_out, (rays.count,)),
                             ("passes_out", passes_out, (1,))):
        if buf is not None and (buf.dtype != torch.int32 or not buf.is_contiguous()
                                or tuple(buf.shape) != shape or buf.device != dev):
            raise ValueError(f"{name} must be a contiguous {shape} int32 CUDA tensor")
    if passes_out is not None:
        passes_out.zero_()
    r = rays.count
    any_pass = torch.empty((r,), dtype=torch.bool, device=dev)
    hit = torch.empty((r,), dtype=torch.bool, device=dev)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri_id = torch.empty((r,), dtype=torch.int32, device=dev)
    steps = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return TraceResult(any_pass=any_pass, hit=hit, t=t, tri_id=tri_id, steps=steps)

    fn = _build.library("traverse_grid").traverse_grid_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([i, i] + [p] * 5 + [i] * 3 + [p] * 4 + [i, i, ctypes.c_double, i, i]
                   + [p] * 8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(int(ray_dtype == torch.float64), int(det_dtype == "float64"),
                 orig.data_ptr(), dirn.data_ptr(),
                 mint.data_ptr(), maxt.data_ptr(), gridf.data_ptr(), nx, ny, nz,
                 occupancy.data_ptr(), cell_range.data_ptr(),
                 cell_tri9.data_ptr(), tri_ids.data_ptr(), r,
                 int(t_gate is not None), float(t_gate or 0.0), int(early_exit),
                 int(stop_on_first_hit), any_pass.data_ptr(), hit.data_ptr(),
                 t.data_ptr(), tri_id.data_ptr(), steps.data_ptr(),
                 tested_out.data_ptr() if tested_out is not None else None,
                 passes_out.data_ptr() if passes_out is not None else None, stream)
    _build.check(err, "traverse_grid")
    traverse_grid_cuda.launches += 1
    if ray_dtype == torch.float64:
        traverse_grid_cuda.launches_f64 += 1
    return TraceResult(any_pass=any_pass, hit=hit, t=t, tri_id=tri_id, steps=steps)


# every launch, and those of the f64-ray instantiations among them
traverse_grid_cuda.launches = 0
traverse_grid_cuda.launches_f64 = 0


def traverse_grid(
    rays: RayBatch, grid: GridArrays, meta: GridMeta, tri9: torch.Tensor, *,
    t_gate: Optional[float] = None, early_exit: bool = False,
    stop_on_first_hit: bool = False, det_dtype: str = "float32",
    tested_out: Optional[torch.Tensor] = None, tables: Optional[DdaTables] = None,
) -> TraceResult:
    """Nearest-hit walk of every ray through the CSR grid: kernel B for
    CUDA tensors (over `tables`, built when not given), the plain version
    for CPU tensors.  tri9 is the (F, 9) `vertex_table`."""
    kw = dict(t_gate=t_gate, early_exit=early_exit,
              stop_on_first_hit=stop_on_first_hit, det_dtype=det_dtype,
              tested_out=tested_out)
    r = rays.count
    if tri9.shape[0] == 0:
        # empty mesh: a valid empty grid, so a valid all-miss trace
        zb = torch.zeros((r,), dtype=torch.bool, device=rays.orig.device)
        if tested_out is not None:
            tested_out.zero_()
        return TraceResult(
            any_pass=zb, hit=zb.clone(),
            t=torch.full((r,), float("inf"), dtype=torch.float32, device=zb.device),
            tri_id=torch.full((r,), -1, dtype=torch.int32, device=zb.device),
            steps=torch.zeros((r,), dtype=torch.int32, device=zb.device),
        )
    if rays.orig.is_cuda:
        return traverse_grid_cuda(rays, grid, meta, tri9, tables=tables, **kw)
    if rays.orig.device.type != "cpu":
        raise ValueError(f"unsupported device {rays.orig.device}")
    return traverse_grid_plain(rays, grid, meta, tri9, **kw)
