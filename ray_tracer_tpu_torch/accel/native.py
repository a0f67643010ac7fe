"""The grid builders on the card: kernels G and H and their plain versions.

Counterpart of `ray_tracer_tpu/accel/native.py`, whose C++ host builders
(`native/raytpu_native.cc`) the JAX package runs ahead of its numpy
fallbacks.  The port binds nothing of `native/`: its builders run on the
card through its own kernels, and on the CPU through their plain PyTorch
versions, which are the port's CPU build (`accel/grid.build_grid` on the
CPU bins through one, `accel/packed.greedy_empty_boxes` is the other on
numpy arrays).

  * `empty_boxes` (`empty_boxes_native`, native.py:151;
    raytpu_native.cc:395-467): the greedy maximal empty box of every
    empty cell, as the packed words `pack_grid` consumes.  Kernel G,
    `csrc/empty_boxes.cu`, grows one cell a thread against a summed-area
    table that `_summed_area` builds with `torch.cumsum`;
    `empty_boxes_plain` is the lock-step round-robin of the JAX package's
    numpy path on tensors, giving the extents.  A cell's growth reads
    only the occupancy and its own extents, so the two give the same bits.
  * `bin_triangles` (the binning of `build_grid_native`, native.py:170;
    raytpu_native.cc:176-314): every triangle into the cells its AABB
    overlaps, with `exact` only those a SAT test in float64 keeps, then a
    stable order by cell.  Kernel H, `csrc/grid_bin.cu`, is two kernels:
    one thread a triangle for its voxel span, then one thread a candidate
    (cell, triangle) pair, tri-major, for the cell and the SAT test; a
    stable `torch.sort` of the cell keys gives each cell its triangles in
    ascending order.  `bin_triangles_plain` is `_build_csr_numpy` and
    `tri_box_overlap` of the JAX package on tensors.

The OBJ parser (`load_obj_native`) stays on the host: text has no form on
the card, and `io/obj.py` reads the JAX package's bytes in numpy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ray_tracer_tpu_torch.kernels import _build

EXT_CAP = 31  # per-direction empty-box extent cap (5 bits each)
_INT_MIN = -(1 << 31)


def _check_occupied(occupied: torch.Tensor, cap: int) -> None:
    if occupied.dtype != torch.bool or occupied.ndim != 3:
        raise ValueError("occupied must be a (nz, ny, nx) bool tensor")
    if not 0 <= cap <= EXT_CAP:
        raise ValueError(f"cap must lie in [0, {EXT_CAP}] (5 bits a direction)")
    nz, ny, nx = occupied.shape
    if (nz + 1) * (ny + 1) * (nx + 1) >= 1 << 31:
        raise ValueError("grid too large for the int32 summed-area table")


def _summed_area(occupied: torch.Tensor) -> torch.Tensor:
    """(nz+1, ny+1, nx+1) int32 summed-area table of the occupancy, a zero
    plane on each low face, by three cumsums (the numpy path's table)."""
    nz, ny, nx = occupied.shape
    s = torch.zeros((nz + 1, ny + 1, nx + 1), dtype=torch.int32, device=occupied.device)
    s[1:, 1:, 1:] = (occupied.to(torch.int32).cumsum(0, dtype=torch.int32)
                     .cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32))
    return s


def pack_extents_words(ext: torch.Tensor) -> torch.Tensor:
    """(6, ...) extents -> (...) int32 words, 5 bits a direction
    ([x-@0, x+@5, y-@10, y+@15, z-@20, z+@25]; bits 30 and 31 clear)."""
    e = ext.to(torch.int32)
    return e[0] | (e[1] << 5) | (e[2] << 10) | (e[3] << 15) | (e[4] << 20) | (e[5] << 25)


def empty_boxes_plain(occupied: torch.Tensor, cap: int = EXT_CAP,
                      tests_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The greedy maximal empty boxes on tensors of any device: the JAX
    package's numpy growth (ray_tracer_tpu/accel/packed.py:188-232).

    occupied (nz, ny, nx) bool -> (6, nz, ny, nx) int32 extents [x-, x+,
    y-, y+, z-, z+].  Every round each direction of each growing cell
    tries one more cell, in that order, against the extents the earlier
    directions of the round reached; a slab is empty when its clipped box
    count is 0 (outside the grid counts as empty).  Occupied cells get
    zeros.  tests_out (1,) int64 gets the slab tests a cell-at-a-time
    loop needs (kernel G's count): each round a cell takes part in tests
    every direction below the cap that has not failed yet.  A failed
    direction stays failed (its slab only widens as the others grow), so
    the lock-step's re-tests of it change no bit and are not counted."""
    _check_occupied(occupied, cap)
    nz, ny, nx = occupied.shape
    dev = occupied.device
    sat = _summed_area(occupied).reshape(-1)
    sy, sz = nx + 1, (ny + 1) * (nx + 1)
    # the sign of each table corner: -1 to the number of low coordinates
    sign = torch.tensor([1, -1], dtype=torch.int32, device=dev)
    sign = (sign[:, None, None] * sign[None, :, None] * sign[None, None, :])[..., None]

    def box_count(zlo, zhi, ylo, yhi, xlo, xhi):
        # inclusive cell-coord box, clipped (outside the grid is empty);
        # its eight table corners gathered at once
        z = torch.stack([(zhi + 1).clamp(0, nz), zlo.clamp(0, nz)]) * sz
        y = torch.stack([(yhi + 1).clamp(0, ny), ylo.clamp(0, ny)]) * sy
        x = torch.stack([(xhi + 1).clamp(0, nx), xlo.clamp(0, nx)])
        corners = (z[:, None, None] + y[None, :, None]) + x[None, None, :]
        return (sat[corners] * sign).sum((0, 1, 2))

    # active set: flat coordinates of empty cells still growing
    zc, yc, xc = torch.nonzero(~occupied, as_tuple=True)
    ext_a = torch.zeros((6, zc.shape[0]), dtype=torch.int64, device=dev)
    failed = torch.zeros((6, zc.shape[0]), dtype=torch.bool, device=dev)
    ext = torch.zeros((6, nz * ny * nx), dtype=torch.int32, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(cap):
        grew_any = torch.zeros(zc.shape[0], dtype=torch.bool, device=dev)
        tests += ((ext_a < cap) & ~failed).sum()
        for d in range(6):
            xlo, xhi = xc - ext_a[0], xc + ext_a[1]
            ylo, yhi = yc - ext_a[2], yc + ext_a[3]
            zlo, zhi = zc - ext_a[4], zc + ext_a[5]
            if d == 0:   slab = (zlo, zhi, ylo, yhi, xlo - 1, xlo - 1)
            elif d == 1: slab = (zlo, zhi, ylo, yhi, xhi + 1, xhi + 1)
            elif d == 2: slab = (zlo, zhi, ylo - 1, ylo - 1, xlo, xhi)
            elif d == 3: slab = (zlo, zhi, yhi + 1, yhi + 1, xlo, xhi)
            elif d == 4: slab = (zlo - 1, zlo - 1, ylo, yhi, xlo, xhi)
            else:        slab = (zhi + 1, zhi + 1, ylo, yhi, xlo, xhi)
            below = ext_a[d] < cap
            ok = below & (box_count(*slab) == 0)
            failed[d] |= below & ~ok
            ext_a[d] += ok
            grew_any |= ok
        if not bool(grew_any.any()):
            break
        if not bool(grew_any.all()):
            # retire saturated cells
            done = ~grew_any
            ext[:, (zc[done] * ny + yc[done]) * nx + xc[done]] = ext_a[:, done].to(torch.int32)
            zc, yc, xc = zc[grew_any], yc[grew_any], xc[grew_any]
            ext_a, failed = ext_a[:, grew_any], failed[:, grew_any]
    # after `cap` rounds every direction is at the cap or has failed: a
    # cell still growing then has nothing left to test
    if zc.shape[0]:
        ext[:, (zc * ny + yc) * nx + xc] = ext_a.to(torch.int32)
    if tests_out is not None:
        tests_out += tests
    return ext.reshape(6, nz, ny, nx)


def empty_boxes_cuda(occupied: torch.Tensor, cap: int = EXT_CAP,
                     tests_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel G on a CUDA occupancy: the plain version's extents as
    (nz, ny, nx) int32 words (`pack_extents_words`), what `pack_grid`
    consumes.  tests_out (1,) int64 on the card gets the slab tests made,
    as the plain version counts them."""
    _check_occupied(occupied, cap)
    if not occupied.is_cuda:
        raise ValueError("empty_boxes_cuda takes CUDA tensors")
    nz, ny, nx = occupied.shape
    dev = occupied.device
    if tests_out is not None and (tests_out.dtype != torch.int64 or tests_out.device != dev):
        raise ValueError("tests_out must be an int64 tensor on the occupancy's device")
    occ = occupied.contiguous()
    sat = _summed_area(occ)
    words = torch.empty((nz, ny, nx), dtype=torch.int32, device=dev)
    if words.numel() == 0:
        return words
    lib = _build.library("empty_boxes")
    fn = lib.empty_boxes_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, p, p, p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(occ.data_ptr(), sat.data_ptr(), nx, ny, nz, int(cap), words.data_ptr(),
                 None if tests_out is None else tests_out.data_ptr(), stream)
    _build.check(err, "empty_boxes")
    empty_boxes_cuda.launches += 1
    return words


empty_boxes_cuda.launches = 0


def empty_boxes(occupied: torch.Tensor, cap: int = EXT_CAP) -> torch.Tensor:
    """The empty boxes' (nz, ny, nx) int32 words: kernel G for a CUDA
    occupancy, the plain version's extents packed for a CPU one."""
    if occupied.is_cuda:
        return empty_boxes_cuda(occupied, cap)
    if occupied.device.type != "cpu":
        raise ValueError(f"unsupported device {occupied.device}")
    return pack_extents_words(empty_boxes_plain(occupied, cap))


# ---- the binning ---------------------------------------------------------


def _pos_to_voxel(p, lower, inv_width, n_voxels):
    """posToVoxel in float32 with numpy's cast: (p - lower) * inv_width,
    truncated to int32, NaN and out-of-range giving INT_MIN as numpy's
    astype does on x86 (a CUDA cast saturates), then clipped to
    [0, n - 1]."""
    v = (p - lower) * inv_width
    ok = (v >= -2147483648.0) & (v < 2147483648.0)
    vi = torch.where(ok, v, torch.zeros_like(v)).to(torch.int32)
    vi = torch.where(ok, vi, torch.full_like(vi, _INT_MIN))
    return torch.minimum(torch.maximum(vi, torch.zeros_like(vi)), n_voxels - 1)


def tri_box_overlap(v0, v1, v2, box_lo, box_hi, pad) -> torch.Tensor:
    """SAT triangle/AABB overlap (Akenine-Möller 2001) in float64 with the
    numpy build's expressions, in its order (ray_tracer_tpu/accel/grid.py
    tri_box_overlap): the triangle-plane axis and the 9 edge-cross axes,
    inclusive comparisons; the box axes are the caller's AABB expansion.
    All inputs (P, 3) float64 -> (P,) bool."""
    c = (box_lo + box_hi) * 0.5
    h = (box_hi - box_lo) * 0.5 + pad
    u0, u1, u2 = v0 - c, v1 - c, v2 - c

    def sep(ax, ay, az):
        """True where the axis (ax, ay, az) separates box and triangle."""
        p0 = ax * u0[:, 0] + ay * u0[:, 1] + az * u0[:, 2]
        p1 = ax * u1[:, 0] + ay * u1[:, 1] + az * u1[:, 2]
        p2 = ax * u2[:, 0] + ay * u2[:, 1] + az * u2[:, 2]
        r = (h[:, 0] * torch.abs(ax) + h[:, 1] * torch.abs(ay)
             + h[:, 2] * torch.abs(az))
        lo = torch.minimum(torch.minimum(p0, p1), p2)
        hi = torch.maximum(torch.maximum(p0, p1), p2)
        return (lo > r) | (hi < -r)

    e0, e1, e2 = u1 - u0, u2 - u1, u0 - u2
    nx = e0[:, 1] * e1[:, 2] - e0[:, 2] * e1[:, 1]
    ny = e0[:, 2] * e1[:, 0] - e0[:, 0] * e1[:, 2]
    nz = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    separated = sep(nx, ny, nz)
    for e in (e0, e1, e2):
        ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
        zero = torch.zeros_like(ex)
        separated |= sep(zero, -ez, ey)
        separated |= sep(ez, zero, -ex)
        separated |= sep(-ey, ex, zero)
    return ~separated


def _check_bin_inputs(verts, faces, n_voxels):
    if verts.dtype != torch.float32 or verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError("verts must be a (V, 3) float32 tensor")
    if faces.dtype != torch.int32 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError("faces must be an (F, 3) int32 tensor")
    if verts.device != faces.device:
        raise ValueError("verts and faces must lie on one device")
    nx, ny, nz = (int(n) for n in n_voxels)
    if min(nx, ny, nz) < 1 or nx * ny * nz >= 1 << 31:
        raise ValueError(f"bad grid resolution {tuple(n_voxels)}")
    return nx, ny, nz


def _vec3(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor([float(x) for x in a], dtype=torch.float32).to(dtype).to(dev)


def bin_triangles_plain(verts: torch.Tensor, faces: torch.Tensor, lower: Sequence[float],
                        inv_width: Sequence[float], width: Sequence[float],
                        n_voxels: Sequence[int], exact: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CSR binning on tensors of any device: the JAX package's
    `_build_csr_numpy` (ray_tracer_tpu/accel/grid.py:146-206).

    verts (V, 3) f32, faces (F, 3) int32; lower, inv_width, width the
    grid's float32 frame (3 floats each), n_voxels (nx, ny, nz).  Each
    triangle expands into its voxel span (float32 posToVoxel), tri-major
    with x outer, y, z inner; with `exact` only the pairs the float64 SAT
    test keeps stay; a stable order by cell (z-major z*nx*ny + y*nx + x)
    keeps each cell's triangles ascending.  -> (cell_start (cells+1,)
    int64, tri_ids (nnz,) int32)."""
    nx, ny, nz = _check_bin_inputs(verts, faces, n_voxels)
    dev = verts.device
    total = nx * ny * nz
    num_tris = faces.shape[0]
    if num_tris == 0:
        return (torch.zeros(total + 1, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    f = faces.long()
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
    tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
    lower_t = _vec3(lower, torch.float32, dev)
    inv_t = _vec3(inv_width, torch.float32, dev)
    n_t = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    vmin = _pos_to_voxel(tri_lo, lower_t, inv_t, n_t)
    vmax = _pos_to_voxel(tri_hi, lower_t, inv_t, n_t)
    span = (vmax - vmin + 1).long()
    per_tri = span[:, 0] * span[:, 1] * span[:, 2]
    starts = torch.cat([per_tri.new_zeros(1), per_tri.cumsum(0)])
    total_entries = int(starts[-1])

    tri_of = torch.repeat_interleave(torch.arange(num_tris, device=dev), per_tri,
                                     output_size=total_entries)
    within = torch.arange(total_entries, device=dev) - starts[tri_of]
    syz = span[tri_of, 1] * span[tri_of, 2]
    dx = within // syz
    rem = within % syz
    dy = rem // span[tri_of, 2]
    dz = rem % span[tri_of, 2]
    x = vmin[tri_of, 0].long() + dx
    y = vmin[tri_of, 1].long() + dy
    z = vmin[tri_of, 2].long() + dz

    if exact:
        # cell boxes in f64 from the f32 grid frame, padded so that the
        # f32 binning error and boundary-touching triangles stay covered
        lo64 = _vec3(lower, torch.float64, dev)
        w64 = _vec3(width, torch.float64, dev)
        idx = torch.stack([x, y, z], dim=1).to(torch.float64)
        box_lo = lo64 + idx * w64
        box_hi = lo64 + (idx + 1.0) * w64
        pad = torch.maximum(w64 * 1e-4, torch.full_like(w64, 1e-12)).expand_as(box_lo)
        ft = f[tri_of]
        v64 = verts.to(torch.float64)
        keep = tri_box_overlap(v64[ft[:, 0]], v64[ft[:, 1]], v64[ft[:, 2]],
                               box_lo, box_hi, pad)
        tri_of, x, y, z = tri_of[keep], x[keep], y[keep], z[keep]

    cell = z * (nx * ny) + y * nx + x  # z-major (grid.h:73-75)
    cell_sorted, order = torch.sort(cell, stable=True)
    tri_ids = tri_of[order].to(torch.int32)
    counts = torch.bincount(cell_sorted, minlength=total)
    cell_start = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return cell_start, tri_ids


def bin_triangles_cuda(verts: torch.Tensor, faces: torch.Tensor, lower: Sequence[float],
                       inv_width: Sequence[float], width: Sequence[float],
                       n_voxels: Sequence[int], exact: bool,
                       candidates_out: Optional[list] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel H on CUDA tensors: the plain version's (cell_start int64,
    tri_ids int32).  The span kernel gives each triangle its voxel span
    and candidate count, one cumsum places its candidates, the bin kernel
    writes each candidate's cell key (past every cell where the SAT test
    rejects it) and triangle, and a stable sort of the keys orders them
    by cell.  candidates_out, a list, gets the candidate count."""
    nx, ny, nz = _check_bin_inputs(verts, faces, n_voxels)
    if not verts.is_cuda:
        raise ValueError("bin_triangles_cuda takes CUDA tensors")
    dev = verts.device
    total = nx * ny * nz
    num_tris = faces.shape[0]
    if num_tris == 0:
        return (torch.zeros(total + 1, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    verts, faces = verts.contiguous(), faces.contiguous()
    lo, hi = torch.aminmax(faces)
    if int(lo) < 0 or int(hi) >= verts.shape[0]:
        raise IndexError("a face indexes past the vertex table")
    lib = _build.library("grid_bin")
    p, i, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    span_fn = lib.grid_span_launch
    span_fn.restype = ctypes.c_int
    span_fn.argtypes = [p, p, i] + [f32] * 6 + [i, i, i, p, p, p]
    bin_fn = lib.grid_bin_launch
    bin_fn.restype = ctypes.c_int
    bin_fn.argtypes = [p, p, p, p, i, ctypes.c_longlong] + [f32] * 6 + [i, i, i, i, p, p, p]
    box = torch.empty((num_tris, 6), dtype=torch.int32, device=dev)
    count = torch.empty((num_tris,), dtype=torch.int64, device=dev)
    lw = [float(x) for x in lower]
    iw = [float(x) for x in inv_width]
    ww = [float(x) for x in width]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = span_fn(verts.data_ptr(), faces.data_ptr(), num_tris, *lw, *iw, nx, ny, nz,
                      box.data_ptr(), count.data_ptr(), stream)
        _build.check(err, "grid_bin (span)")
        ends = count.cumsum(0)
        n_cand = int(ends[-1])
        keys = torch.empty((n_cand,), dtype=torch.int32, device=dev)
        tri = torch.empty((n_cand,), dtype=torch.int32, device=dev)
        err = bin_fn(verts.data_ptr(), faces.data_ptr(), box.data_ptr(), ends.data_ptr(),
                     num_tris, n_cand, *lw, *ww, nx, ny, nz, int(bool(exact)),
                     keys.data_ptr(), tri.data_ptr(), stream)
    _build.check(err, "grid_bin")
    bin_triangles_cuda.launches += 1
    if candidates_out is not None:
        candidates_out.append(n_cand)
    # rejected pairs carry the key `total` and sort past every cell
    counts = torch.bincount(keys, minlength=total + 1)[:total]
    cell_start = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    order = torch.sort(keys, stable=True).indices
    nnz = int(cell_start[-1])
    return cell_start, tri[order[:nnz]]


bin_triangles_cuda.launches = 0


def bin_triangles(verts: torch.Tensor, faces: torch.Tensor, lower: Sequence[float],
                  inv_width: Sequence[float], width: Sequence[float],
                  n_voxels: Sequence[int], exact: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel H for CUDA tensors, the plain version for CPU tensors ->
    (cell_start (cells+1,) int64, tri_ids (nnz,) int32) on their device."""
    if verts.is_cuda:
        return bin_triangles_cuda(verts, faces, lower, inv_width, width, n_voxels, exact)
    if verts.device.type != "cpu":
        raise ValueError(f"unsupported device {verts.device}")
    return bin_triangles_plain(verts, faces, lower, inv_width, width, n_voxels, exact)
