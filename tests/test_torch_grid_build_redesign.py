"""Kernels G and H as redesigned: their plain versions and models on the CPU.

  * the jumped `empty_boxes_plain` (accel/native.py) bitwise the JAX
    package's numpy growth (its native path forced off) at caps 31, 3 and
    0: on an empty and a full grid, one occupied cell at the centre,
    occupied cells at Chebyshev distance exactly cap and cap + 1 from a
    probe cell, and the random occupancies of test_torch_native_build.py;
    its greedy slab-test count that of a cell-at-a-time greedy loop, and
    its `queries_out` (probes, slab tests made) that of a cell-at-a-time
    model of the jumped loop, kernel G's state machine in Python;
  * a numpy model of kernel H's counting scatter (the arrival order
    shuffled under five seeds: a slot a kept pair from its cell's count,
    the scan, the scatter, each cell sorted by the kernel's three tiers)
    gives the stable sort's CSR bitwise on spot's and a random soup's
    candidates, AABB and SAT-exact;
  * a face index past the vertex table raises IndexError on the CPU path.
"""

import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.accel import packed as jax_packed  # noqa: E402
from ray_tracer_tpu_torch.accel import native  # noqa: E402
from ray_tracer_tpu_torch.accel.grid import build_grid  # noqa: E402
from ray_tracer_tpu_torch.io.obj import load_obj  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
SORT_TIERS = (32, 4096)  # a warp's shuffles, kBlockSort (csrc/grid_bin.cu)


def _jax_numpy_boxes(occ, cap):
    with mock.patch("ray_tracer_tpu.accel.native.empty_boxes_native", return_value=None):
        return jax_packed.greedy_empty_boxes(occ, cap)


def _occupancy(kind, cap):
    rng = np.random.default_rng(11)
    if kind == "empty":
        return np.zeros((4, 3, 5), bool)
    if kind == "full":
        return np.ones((4, 3, 5), bool)
    if kind == "centre":
        occ = np.zeros((7, 7, 7), bool)
        occ[3, 3, 3] = True
        return occ
    if kind in ("at_cap", "past_cap"):
        # the probe cell (1, 2, 1); one occupied cell at Chebyshev distance
        # cap (the cube stops one short of the cap) or cap + 1 (it reaches it)
        d = cap if kind == "at_cap" else cap + 1
        occ = np.zeros((4, 4, cap + 4), bool)
        occ[1 + min(d, 2), 2 - min(d, 2), 1 + d] = True
        return occ
    if kind == "sparse":
        return rng.random((9, 7, 12)) < 0.1
    if kind == "cube":
        return rng.random((20, 20, 20)) < 0.02
    if kind == "tall":
        return rng.random((5, 40, 3)) < 0.3
    occ = np.zeros((1, 6, 6), bool)  # a 1-thick slab with a hole
    occ[0, 2:4, 2:4] = True
    return occ


class _Table:
    """The clipped box count of kernel G on a Python list (fast scalar reads)."""

    def __init__(self, occ):
        nz, ny, nx = occ.shape
        sat = np.zeros((nz + 1, ny + 1, nx + 1), np.int64)
        sat[1:, 1:, 1:] = occ.astype(np.int64).cumsum(0).cumsum(1).cumsum(2)
        self.s = sat.reshape(-1).tolist()
        self.n = (nz, ny, nx)
        self.sy, self.sz = nx + 1, (ny + 1) * (nx + 1)

    def count(self, zlo, zhi, ylo, yhi, xlo, xhi):
        nz, ny, nx = self.n
        zlo, zhi = min(max(zlo, 0), nz) * self.sz, min(max(zhi + 1, 0), nz) * self.sz
        ylo, yhi = min(max(ylo, 0), ny) * self.sy, min(max(yhi + 1, 0), ny) * self.sy
        xlo, xhi = min(max(xlo, 0), nx), min(max(xhi + 1, 0), nx)
        s = self.s
        return (s[zhi + yhi + xhi] - s[zlo + yhi + xhi] - s[zhi + ylo + xhi]
                - s[zhi + yhi + xlo] + s[zlo + ylo + xhi] + s[zlo + yhi + xlo]
                + s[zhi + ylo + xlo] - s[zlo + ylo + xlo])


def _box(x, y, z, e):
    return (z - e[4], z + e[5], y - e[2], y + e[3], x - e[0], x + e[1])


def _slab(x, y, z, e, d):
    zlo, zhi, ylo, yhi, xlo, xhi = _box(x, y, z, e)
    return ((zlo, zhi, ylo, yhi, xlo - 1, xlo - 1), (zlo, zhi, ylo, yhi, xhi + 1, xhi + 1),
            (zlo, zhi, ylo - 1, ylo - 1, xlo, xhi), (zlo, zhi, yhi + 1, yhi + 1, xlo, xhi),
            (zlo - 1, zlo - 1, ylo, yhi, xlo, xhi), (zhi + 1, zhi + 1, ylo, yhi, xlo, xhi))[d]


def _greedy_loop(occ, cap):
    """raytpu_native.cc:419-447 a cell at a time (a failed direction not
    tested again) -> (extents, slab tests)."""
    t = _Table(occ)
    ext = np.zeros((6,) + occ.shape, np.int32)
    tests = 0
    for z, y, x in np.argwhere(~occ).tolist():
        e, failed, grew = [0] * 6, [False] * 6, True
        while grew:
            grew = False
            for d in range(6):
                if e[d] >= cap or failed[d]:
                    continue
                tests += 1
                if t.count(*_slab(x, y, z, e, d)) == 0:
                    e[d] += 1
                    grew = True
                else:
                    failed[d] = True
        ext[:, z, y, x] = e
    return ext, tests


def _jumped_loop(occ, cap):
    """Kernel G's state machine a cell at a time: a binary search of the
    largest j whose box (the open directions grown by j, to the cap) is
    empty, the jump, one greedy round, again until a round grows nothing
    -> (extents, greedy slab tests, probes, slab tests made)."""
    t = _Table(occ)
    ext = np.zeros((6,) + occ.shape, np.int32)
    greedy = probes = made = 0
    for z, y, x in np.argwhere(~occ).tolist():
        e, failed = [0] * 6, [False] * 6
        while True:
            open_dirs = [d for d in range(6) if not failed[d] and e[d] < cap]
            if not open_dirs:
                break
            lo, hi = 0, cap - min(e[d] for d in open_dirs)
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                probes += 1
                g = [e[d] if failed[d] else min(e[d] + mid, cap) for d in range(6)]
                if t.count(*_box(x, y, z, g)) == 0:
                    lo = mid
                else:
                    hi = mid - 1
            for d in range(6):
                if not failed[d]:
                    step = min(lo, cap - e[d])
                    greedy += step
                    e[d] += step
            grew = False
            for d in range(6):
                if failed[d] or e[d] >= cap:
                    continue
                greedy += 1
                made += 1
                if t.count(*_slab(x, y, z, e, d)) == 0:
                    e[d] += 1
                    grew = True
                else:
                    failed[d] = True
            if not grew:
                break
        ext[:, z, y, x] = e
    return ext, greedy, probes, made


KINDS = ["empty", "full", "centre", "at_cap", "past_cap", "sparse", "cube", "tall", "slab"]


@pytest.mark.parametrize("cap", [31, 3, 0])
@pytest.mark.parametrize("kind", KINDS)
def test_jumped_empty_boxes_equal_jax_and_models(kind, cap):
    """Bitwise the JAX package's numpy growth; the greedy count that of the
    cell-at-a-time greedy loop, the queries those of the jumped model."""
    occ = _occupancy(kind, cap)
    tests = torch.zeros(1, dtype=torch.int64)
    queries = torch.zeros(2, dtype=torch.int64)
    got = native.empty_boxes_plain(torch.from_numpy(occ), cap, tests_out=tests,
                                   queries_out=queries)
    np.testing.assert_array_equal(got.numpy(), _jax_numpy_boxes(occ, cap))
    ext, greedy, probes, made = _jumped_loop(occ, cap)
    np.testing.assert_array_equal(ext, got.numpy())
    assert int(tests) == greedy
    assert queries.tolist() == [probes, made]
    if kind != "cube":  # the greedy loop at 20^3 costs seconds of Python
        ext_g, greedy_g = _greedy_loop(occ, cap)
        np.testing.assert_array_equal(ext_g, got.numpy())
        assert greedy_g == greedy
    if kind == "empty":
        assert (got.numpy() == cap).all() and queries.tolist()[1] == 0
    if kind in ("at_cap", "past_cap") and cap > 0:
        # the probe cell's cube radius: cap - 1 (it grows on) or cap (done)
        k = cap - 1 if kind == "at_cap" else cap
        assert got.numpy()[:, 1, 2, 1].min() >= k


# ---- kernel H's counting scatter -------------------------------------------


def _soup():
    rng = np.random.default_rng(5)
    verts = np.concatenate([rng.random((60, 3)) * 8.0,
                            rng.integers(0, 9, (30, 3)).astype(np.float64),
                            np.array([[0.0, 0.0, 0.0], [8.0, 8.0, 8.0]])]).astype(np.float32)
    faces = rng.integers(0, verts.shape[0], (120, 3))
    faces[:5] = faces[:5, :1]  # points
    faces[10:40] = rng.integers(60, 90, (30, 3))  # every vertex on cell planes
    return verts, faces.astype(np.int32)


def _mesh(name):
    if name == "spot":
        m = load_obj(os.path.join(ASSETS, "spot_triangulated.obj"))
        return m.verts, m.faces, (3.0, 64)
    return (*_soup(), (3.0, 8))


def _pairs(grid):
    cs = grid.host.cell_start
    return np.repeat(np.arange(cs.shape[0] - 1), np.diff(cs)), grid.host.tri_ids


def _ranks(seg):
    arr = np.asarray(seg)
    out = np.empty_like(arr)
    out[(arr[None, :] < arr[:, None]).sum(1)] = arr
    return out.tolist()


def _bitonic(seg):
    n = len(seg)
    size = 64
    while size < n:
        size <<= 1
    a = list(seg) + [2 ** 31 - 1] * (size - n)
    k = 2
    while k <= size:
        j = k >> 1
        while j:
            for i in range(size):
                ij = i ^ j
                if ij > i and (a[i] > a[ij]) == ((i & k) == 0):
                    a[i], a[ij] = a[ij], a[i]
            j >>= 1
        k <<= 1
    return a[:n]


def _cell_sort(seg, tiers):
    """Kernel H's per-cell sort: ranks over a warp's shuffles, a block's
    bitonic sort in shared memory, ranks over the segment past it."""
    if len(seg) <= tiers[0]:
        return _ranks(seg)
    if len(seg) <= tiers[1]:
        return _bitonic(seg)
    return _ranks(seg)


def _counting_scatter(cell, tri, kept, n_cells, seed, tiers):
    """The count, scan, scatter and per-cell sort, the candidates arriving
    at the atomics in a shuffled order -> (cell_start, tri_ids)."""
    order = np.random.default_rng(seed).permutation(cell.shape[0])
    cell, tri = cell[order][kept[order]], tri[order][kept[order]]
    # each kept pair's slot: its cell's count when its atomicAdd arrived
    by_cell = np.argsort(cell, kind="stable")
    counts = np.bincount(cell, minlength=n_cells)
    first = np.concatenate([[0], np.cumsum(counts)])
    slot = np.empty_like(cell)
    slot[by_cell] = np.arange(cell.shape[0]) - first[cell[by_cell]]
    buf = np.empty_like(tri)
    buf[first[cell] + slot] = tri
    out = np.concatenate([_cell_sort(buf[first[c]:first[c + 1]].tolist(), tiers)
                          for c in np.flatnonzero(counts)] + [[]]).astype(np.int32)
    return first, out


@pytest.mark.parametrize("exact", [False, True], ids=["aabb", "exact"])
@pytest.mark.parametrize("name", ["spot", "soup"])
def test_counting_scatter_gives_the_stable_sort(name, exact):
    """Every candidate of the AABB spans arrives in a shuffled order; the
    kept ones (all, or the SAT test's) give the plain binning's CSR."""
    verts, faces, (rm, max_res) = _mesh(name)
    aabb = build_grid(verts, faces, rm, max_res, exact_overlap=False, device="cpu")
    want = build_grid(verts, faces, rm, max_res, exact_overlap=exact, device="cpu")
    n_cells = aabb.meta.total_voxels
    cell, tri = _pairs(aabb)
    kept_cell, kept_tri = _pairs(want)
    kept = np.isin(cell * faces.shape[0] + tri, kept_cell * faces.shape[0] + kept_tri)
    assert int(kept.sum()) == want.meta.nnz
    runs = [(seed, SORT_TIERS) for seed in range(5)] + [(0, (2, 8))]  # every tier
    for seed, tiers in runs:
        cs, ids = _counting_scatter(cell, tri, kept, n_cells, seed, tiers)
        assert np.array_equal(cs, want.host.cell_start), (seed, tiers)
        assert ids.dtype == want.host.tri_ids.dtype and np.array_equal(ids, want.host.tri_ids)


def test_face_index_past_the_table_raises_on_the_cpu():
    verts, faces = _soup()
    bad = faces.copy()
    bad[7, 1] = verts.shape[0]
    with pytest.raises(IndexError):
        build_grid(verts, bad, 3.0, 8, exact_overlap=True, device="cpu")
    lower, inv, width = np.zeros(3, np.float32), np.ones(3, np.float32), np.ones(3, np.float32)
    with pytest.raises(IndexError):
        native.bin_triangles(torch.from_numpy(verts), torch.from_numpy(bad), lower, inv, width,
                             (8, 8, 8), False)
