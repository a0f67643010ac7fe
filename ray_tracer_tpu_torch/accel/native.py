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
    `csrc/empty_boxes.cu`, builds its own summed-area table and grows a
    cell a thread with exact jumps (the largest box that the next rounds
    would all grow into, by binary search), the warp's lanes in step;
    `empty_boxes_plain` is the lock-step round-robin of the JAX package's
    numpy path on tensors with the same jumps, giving the extents.  A
    cell's growth reads only the occupancy and its own extents, so the two
    give the same bits, and the same counts.
  * `bin_triangles` (the binning of `build_grid_native`, native.py:170;
    raytpu_native.cc:176-314): every triangle into the cells its AABB
    overlaps, with `exact` only those a SAT test in float64 keeps, each
    cell's triangles ascending.  Kernel H, `csrc/grid_bin.cu`, is a
    counting scatter: a span kernel (a thread a triangle), a count kernel
    with the SAT test (a thread a candidate pair, tri-major), a scan of
    the counts, a scatter, and a sort of each cell on the card; two host
    reads.  `bin_triangles_plain` is `_build_csr_numpy` and
    `tri_box_overlap` of the JAX package on tensors, ordered by a stable
    sort of the cell keys.

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
_P, _I, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LAUNCHERS = {}


def _launcher(lib: str, name: str, argtypes):
    """The C launcher `name` of kernel library `lib`, its signature set once."""
    fn = _LAUNCHERS.get((lib, name))
    if fn is None:
        fn = getattr(_build.library(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _LAUNCHERS[(lib, name)] = fn
    return fn


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
    plane on each low face, by three cumsums (the numpy path's table; the
    plain version's, kernel G builds its own)."""
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
                      tests_out: Optional[torch.Tensor] = None,
                      queries_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The greedy maximal empty boxes on tensors of any device: the JAX
    package's numpy growth (ray_tracer_tpu/accel/packed.py:188-232), with
    kernel G's exact jumps.

    occupied (nz, ny, nx) bool -> (6, nz, ny, nx) int32 extents [x-, x+,
    y-, y+, z-, z+].  Every round each direction of each growing cell
    tries one more cell, in that order, against the extents the earlier
    directions of the round reached; a slab is empty when its clipped box
    count is 0 (outside the grid counts as empty).  Occupied cells get
    zeros.  Before each round a cell jumps: the largest j in [0, jmax]
    whose box B_j (each direction that has not failed grown by j, at most
    to the cap) is empty, by binary search, is the number of rounds that
    would all succeed, so the extents take those rounds at once.  tests_out
    (1,) int64 gets the slab tests a cell-at-a-time greedy loop needs
    (each round a cell tests every direction below the cap that has not
    failed yet; a jump by j adds them for its j rounds); queries_out (2,)
    int64 the box counts made, the jumps' probes and the slab tests (kernel
    G's counters).  A failed direction stays failed (its slab only widens
    as the others grow), so the lock-step's re-tests of it change no bit
    and are not counted."""
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
    probes = torch.zeros((), dtype=torch.int64, device=dev)
    made = torch.zeros((), dtype=torch.int64, device=dev)
    while zc.shape[0]:
        # the jump: binary search of the largest j in [0, jmax] with B_j empty
        open_dir = ~failed & (ext_a < cap)
        hi = torch.where(open_dir, cap - ext_a, torch.zeros_like(ext_a)).amax(0)
        lo = torch.zeros_like(hi)
        while True:
            searching = lo < hi
            if not bool(searching.any()):
                break
            probes += searching.sum()
            mid = (lo + hi + 1) >> 1
            g = torch.where(failed, ext_a, torch.clamp(ext_a + mid, max=cap))
            empty = box_count(zc - g[4], zc + g[5], yc - g[2], yc + g[3],
                              xc - g[0], xc + g[1]) == 0
            lo = torch.where(searching & empty, mid, lo)
            hi = torch.where(searching & ~empty, mid - 1, hi)
        step = torch.where(failed, torch.zeros_like(ext_a), torch.minimum(lo, cap - ext_a))
        tests += step.sum()
        ext_a += step
        # one greedy round
        grew_any = torch.zeros(zc.shape[0], dtype=torch.bool, device=dev)
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
            tested = ~failed[d] & (ext_a[d] < cap)
            made += tested.sum()
            ok = tested & (box_count(*slab) == 0)
            failed[d] |= tested & ~ok
            ext_a[d] += ok
            grew_any |= ok
        # a cell that did not grow is final: a round after a jump short of
        # the cap fails somewhere, so each cell retires within seven rounds
        done = ~grew_any
        if bool(done.any()):
            ext[:, (zc[done] * ny + yc[done]) * nx + xc[done]] = ext_a[:, done].to(torch.int32)
            zc, yc, xc = zc[grew_any], yc[grew_any], xc[grew_any]
            ext_a, failed = ext_a[:, grew_any], failed[:, grew_any]
    if tests_out is not None:
        tests_out += tests + made
    if queries_out is not None:
        queries_out += torch.stack([probes, made])
    return ext.reshape(6, nz, ny, nx)


def empty_boxes_cuda(occupied: torch.Tensor, cap: int = EXT_CAP,
                     tests_out: Optional[torch.Tensor] = None,
                     queries_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel G on a CUDA occupancy: the plain version's extents as
    (nz, ny, nx) int32 words (`pack_extents_words`), what `pack_grid`
    consumes.  tests_out (1,) and queries_out (2,) int64 on the card get
    the greedy loop's slab tests and the box counts made (probes, slab
    tests), as the plain version counts them."""
    _check_occupied(occupied, cap)
    if not occupied.is_cuda:
        raise ValueError("empty_boxes_cuda takes CUDA tensors")
    nz, ny, nx = occupied.shape
    dev = occupied.device
    for name, out, n in (("tests_out", tests_out, 1), ("queries_out", queries_out, 2)):
        if out is not None and (out.dtype != torch.int64 or out.device != dev
                                or out.numel() != n):
            raise ValueError(f"{name} must be a ({n},) int64 tensor on the occupancy's device")
    occ = occupied.contiguous()
    words = torch.empty((nz, ny, nx), dtype=torch.int32, device=dev)
    if words.numel() == 0:
        return words
    sat = torch.empty((nz + 1, ny + 1, nx + 1), dtype=torch.int32, device=dev)
    fn = _launcher("empty_boxes", "empty_boxes_launch", [_P, _P, _I, _I, _I, _I] + [_P] * 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(occ.data_ptr(), sat.data_ptr(), nx, ny, nz, int(cap), words.data_ptr(),
                 None if tests_out is None else tests_out.data_ptr(),
                 None if queries_out is None else queries_out.data_ptr(), stream)
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
    `_build_csr_numpy` (ray_tracer_tpu/accel/grid.py:307-373; `tri_box_overlap`
    :120).

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
                       candidates_out: Optional[list] = None,
                       parts_out: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel H on CUDA tensors: the plain version's (cell_start int64,
    tri_ids int32), by a counting scatter.  The span kernel gives each
    triangle its voxel span and candidate count (and flags a face index out
    of range), a cumsum places its candidates, and one host read takes the
    candidate count with the flag; the count kernel runs each candidate's
    SAT test and counts the kept pairs a cell, a cumsum of the counts is
    cell_start, and the place kernels scatter the kept pairs and sort each
    cell; the second host read is nnz.  candidates_out, a list, gets the
    candidate count; parts_out, a dict, the CUDA-event ms of each part
    (span, cumsum_and_read, count, scan, place, read_nnz)."""
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
    span_fn = _launcher("grid_bin", "grid_span_launch",
                        [_P, _I, _P, _I] + [_F32] * 6 + [_I, _I, _I, _P, _P, _P, _P])
    count_fn = _launcher("grid_bin", "grid_count_launch",
                         [_P, _P, _P, _P, _I, _I64] + [_F32] * 6 + [_I, _I, _I, _I] + [_P] * 5)
    place_fn = _launcher("grid_bin", "grid_place_launch", [_P] * 4 + [_I64, _I, _P, _P, _P])
    marks = [] if parts_out is not None else None

    def mark(name):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

    box = torch.empty((num_tris, 6), dtype=torch.int32, device=dev)
    # one zeroed buffer: each triangle's candidate count, scanned in place
    # into its end, and the face flag after them; then each cell's kept
    # pairs after a zero, scanned in place into cell_start
    zeroed = torch.zeros((num_tris + 1 + total + 1,), dtype=torch.int64, device=dev)
    ends, flag = zeroed[:num_tris], zeroed[num_tris:num_tris + 1]
    cell_start = zeroed[num_tris + 1:]
    lw = [float(x) for x in lower]
    iw = [float(x) for x in inv_width]
    ww = [float(x) for x in width]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        mark("start")
        err = span_fn(verts.data_ptr(), verts.shape[0], faces.data_ptr(), num_tris, *lw, *iw,
                      nx, ny, nz, box.data_ptr(), ends.data_ptr(), flag.data_ptr(), stream)
        _build.check(err, "grid_bin (span)")
        mark("span")
        ends.cumsum_(0)
        n_cand, n_bad = zeroed[num_tris - 1:num_tris + 1].tolist()  # host read 1
        mark("cumsum_and_read")
        if n_bad:
            raise IndexError("a face indexes past the vertex table")
        key, slot, tri, buf = torch.empty((4, n_cand), dtype=torch.int32, device=dev)
        out = torch.empty((n_cand,), dtype=torch.int32, device=dev)
        err = count_fn(verts.data_ptr(), faces.data_ptr(), box.data_ptr(), ends.data_ptr(),
                       num_tris, n_cand, *lw, *ww, nx, ny, nz, int(bool(exact)),
                       cell_start[1:].data_ptr(), key.data_ptr(), slot.data_ptr(),
                       tri.data_ptr(), stream)
        _build.check(err, "grid_bin (count)")
        mark("count")
        cell_start[1:].cumsum_(0)
        mark("scan")
        err = place_fn(key.data_ptr(), slot.data_ptr(), tri.data_ptr(), cell_start.data_ptr(),
                       n_cand, total, buf.data_ptr(), out.data_ptr(), stream)
        _build.check(err, "grid_bin (place)")
        mark("place")
        nnz = int(cell_start[-1])  # host read 2
        mark("read_nnz")
    bin_triangles_cuda.launches += 1
    if candidates_out is not None:
        candidates_out.append(n_cand)
    if marks is not None:
        marks[-1][1].synchronize()
        parts_out.update({b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])})
    return cell_start, out[:nnz]


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
