"""The port's grid builders (accel/native.py) against the JAX package's.

The plain versions of kernels G and H, which the port runs on the CPU,
against the JAX package's numpy builders (native path forced off) and
its C++ builders (`ray_tracer_tpu.accel.native`, built by conftest):

  * the greedy empty boxes on random occupancies at three shapes and
    densities and on the degenerate grids, caps 31 and 3, bitwise; the
    slab tests counted as a cell-at-a-time loop makes them (kernel G's
    count);
  * the binning, AABB and SAT-exact, on spot, blub, a small nefertiti, a
    flat plane, a random soup with point and line triangles and triangles
    on cell planes, and at a forced resolution: cell_start and tri_ids
    bitwise;
  * CPU tensors take the plain versions and launch nothing; a card asked
    for where there is none raises.
"""

import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.accel import native as jax_native  # noqa: E402
from ray_tracer_tpu.accel import packed as jax_packed  # noqa: E402
from ray_tracer_tpu.accel.grid import build_grid as jax_build_grid  # noqa: E402
from ray_tracer_tpu_torch.accel import native  # noqa: E402
from ray_tracer_tpu_torch.accel import packed  # noqa: E402
from ray_tracer_tpu_torch.accel.grid import build_grid  # noqa: E402
from ray_tracer_tpu_torch.io.obj import load_obj  # noqa: E402
from ray_tracer_tpu_torch.models import meshes, scenes  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def _jax_numpy_boxes(occ, cap):
    """The JAX package's numpy growth, its native fast path turned off."""
    with mock.patch("ray_tracer_tpu.accel.native.empty_boxes_native", return_value=None):
        return jax_packed.greedy_empty_boxes(occ, cap)


def _occupancy(kind):
    rng = np.random.default_rng(11)
    if kind == "sparse":
        return rng.random((9, 7, 12)) < 0.1
    if kind == "cube":
        return rng.random((20, 20, 20)) < 0.02
    if kind == "tall":
        return rng.random((5, 40, 3)) < 0.3
    if kind == "full":
        return np.ones((4, 3, 5), bool)
    if kind == "empty":
        return np.zeros((4, 3, 5), bool)
    if kind == "single":
        return np.zeros((1, 1, 1), bool)
    occ = np.zeros((1, 6, 6), bool)  # a 1-thick slab with a hole
    occ[0, 2:4, 2:4] = True
    return occ


@pytest.mark.parametrize("cap", [31, 3])
@pytest.mark.parametrize("kind", ["sparse", "cube", "tall", "full", "empty", "single", "slab"])
def test_empty_boxes_plain_equal_jax(kind, cap):
    """Bitwise the JAX package's numpy growth and its C++ builder."""
    occ = _occupancy(kind)
    got = native.empty_boxes_plain(torch.from_numpy(occ), cap)
    assert got.dtype == torch.int32 and tuple(got.shape) == (6,) + occ.shape
    np.testing.assert_array_equal(got.numpy(), _jax_numpy_boxes(occ, cap))
    if jax_native.available():
        np.testing.assert_array_equal(got.numpy(), jax_native.empty_boxes_native(occ, cap))
    np.testing.assert_array_equal(packed.greedy_empty_boxes(occ, cap), got.numpy())


def _cell_loop(occ, cap, skip_failed=True):
    """raytpu_native.cc:419-447 in Python, one cell at a time, with kernel
    G's skip of directions that have failed: -> (extents (6, nz, ny, nx),
    slab tests made)."""
    nz, ny, nx = occ.shape
    sat = np.zeros((nz + 1, ny + 1, nx + 1), np.int64)
    sat[1:, 1:, 1:] = occ.astype(np.int64).cumsum(0).cumsum(1).cumsum(2)

    def count(zlo, zhi, ylo, yhi, xlo, xhi):
        zlo, zhi = min(max(zlo, 0), nz), min(max(zhi + 1, 0), nz)
        ylo, yhi = min(max(ylo, 0), ny), min(max(yhi + 1, 0), ny)
        xlo, xhi = min(max(xlo, 0), nx), min(max(xhi + 1, 0), nx)
        return (sat[zhi, yhi, xhi] - sat[zlo, yhi, xhi] - sat[zhi, ylo, xhi]
                - sat[zhi, yhi, xlo] + sat[zlo, ylo, xhi] + sat[zlo, yhi, xlo]
                + sat[zhi, ylo, xlo] - sat[zlo, ylo, xlo])

    ext = np.zeros((6, nz, ny, nx), np.int32)
    tests = 0
    for z, y, x in np.argwhere(~occ):
        e = [0] * 6
        failed = [False] * 6
        grew = True
        while grew:
            grew = False
            for d in range(6):
                if e[d] >= cap or (skip_failed and failed[d]):
                    continue
                tests += 1
                xlo, xhi, ylo, yhi, zlo, zhi = (x - e[0], x + e[1], y - e[2], y + e[3],
                                                z - e[4], z + e[5])
                slab = ((zlo, zhi, ylo, yhi, xlo - 1, xlo - 1),
                        (zlo, zhi, ylo, yhi, xhi + 1, xhi + 1),
                        (zlo, zhi, ylo - 1, ylo - 1, xlo, xhi),
                        (zlo, zhi, yhi + 1, yhi + 1, xlo, xhi),
                        (zlo - 1, zlo - 1, ylo, yhi, xlo, xhi),
                        (zhi + 1, zhi + 1, ylo, yhi, xlo, xhi))[d]
                if count(*slab) == 0:
                    e[d] += 1
                    grew = True
                else:
                    failed[d] = True
        ext[:, z, y, x] = e
    return ext, tests


@pytest.mark.parametrize("cap", [31, 3, 0])
@pytest.mark.parametrize("kind", ["sparse", "empty", "slab"])
def test_empty_boxes_plain_is_the_cell_loop(kind, cap):
    """The lock-step growth gives a cell-at-a-time loop's extents, and
    counts the slab tests that loop makes (kernel G's counter); the loop
    without the skip of failed directions gives the same extents."""
    occ = _occupancy(kind)
    tests = torch.zeros(1, dtype=torch.int64)
    got = native.empty_boxes_plain(torch.from_numpy(occ), cap, tests_out=tests)
    want, n = _cell_loop(occ, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(tests) == n
    np.testing.assert_array_equal(_cell_loop(occ, cap, skip_failed=False)[0], want)


def test_empty_boxes_words_and_cpu_dispatch():
    """`empty_boxes` on a CPU tensor runs the plain version (no launch)
    and gives the JAX package's pack_extents words."""
    occ = _occupancy("cube")
    before = native.empty_boxes_cuda.launches
    words = native.empty_boxes(torch.from_numpy(occ))
    assert native.empty_boxes_cuda.launches == before
    assert words.dtype == torch.int32 and tuple(words.shape) == occ.shape
    np.testing.assert_array_equal(
        words.numpy(), native.pack_extents_words(native.empty_boxes_plain(torch.from_numpy(occ)))
        .numpy())
    want = jax_packed.pack_extents(_jax_numpy_boxes(occ, native.EXT_CAP))
    assert words.numpy().view(np.uint32).tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="CUDA"):
        native.empty_boxes_cuda(torch.from_numpy(occ))
    with pytest.raises(ValueError, match="cap"):
        native.empty_boxes(torch.from_numpy(occ), cap=32)


# ---- the binning -----------------------------------------------------------


def _soup():
    """A random soup in [0, 8]^3 with point and line triangles and
    triangles whose vertices lie on the cell planes of an 8^3 grid of
    unit cells (corners at 0 and 8 fix the frame)."""
    rng = np.random.default_rng(5)
    verts = [rng.random((60, 3)) * 8.0,
             rng.integers(0, 9, (30, 3)).astype(np.float64),  # on cell planes
             np.array([[0.0, 0.0, 0.0], [8.0, 8.0, 8.0]])]
    verts = np.concatenate(verts).astype(np.float32)
    faces = rng.integers(0, verts.shape[0], (120, 3))
    faces[:5] = faces[:5, :1]  # points
    line = rng.integers(0, 60, (5, 2))
    faces[5:10] = np.stack([line[:, 0], line[:, 1], line[:, 1]], 1)  # lines
    faces[10:40] = rng.integers(60, 90, (30, 3))  # every vertex on cell planes
    faces[40] = (90, 91, 91)
    return verts, faces.astype(np.int32)


def _mesh(name):
    if name in ("spot", "blub"):
        m = load_obj(os.path.join(ASSETS, f"{name}_triangulated.obj"))
        return m.verts, m.faces
    if name == "nefertiti":
        return scenes.concat_mesh_arrays(scenes.nefertiti_mesh_parts(n_lat=32, n_lon=64))[:2]
    if name == "plane":  # y constant: a zero-width axis (inv_width 0)
        m = meshes.make_plane(extent=4.0, density=6)
        return m.verts, m.faces
    return _soup()


# (resolution_multiplier, max_resolution) per mesh: the soup's 8 cells an
# axis are unit cells
KNOBS = {"spot": (3.0, 64), "blub": (2.0, 32), "nefertiti": (2.0, 128), "plane": (3.0, 64),
         "soup": (3.0, 8)}


@pytest.mark.parametrize("exact", [False, True], ids=["aabb", "exact"])
@pytest.mark.parametrize("name", sorted(KNOBS))
def test_binning_equal_jax_numpy_and_native(name, exact):
    """build_grid on the CPU (the plain binning) gives the JAX package's
    numpy build's and its C++ builder's cell_start and tri_ids."""
    verts, faces = _mesh(name)
    rm, max_res = KNOBS[name]
    got = build_grid(verts, faces, rm, max_res, exact_overlap=exact, device="cpu")
    want = jax_build_grid(verts, faces, rm, max_res, use_native=False, exact_overlap=exact)
    assert got.meta == tuple(want.meta)
    assert got.meta.nnz > 0
    assert got.host.cell_start.dtype == np.int64 and got.host.tri_ids.dtype == np.int32
    np.testing.assert_array_equal(got.host.cell_start, want.host.cell_start)
    np.testing.assert_array_equal(got.host.tri_ids, want.host.tri_ids)
    if jax_native.available():
        nat = jax_build_grid(verts, faces, rm, max_res, use_native=True, exact_overlap=exact)
        assert got.meta == tuple(nat.meta)
        np.testing.assert_array_equal(got.host.cell_start, np.asarray(nat.host.cell_start))
        np.testing.assert_array_equal(got.host.tri_ids, np.asarray(nat.host.tri_ids))
    if name == "soup":
        np.testing.assert_array_equal(got.host.width, np.ones(3, np.float32))


@pytest.mark.parametrize("exact", [False, True], ids=["aabb", "exact"])
def test_binning_force_resolution_equal_jax(exact):
    """A half of spot's faces at a forced (odd) resolution, as the ring
    builds its shards."""
    verts, faces = _mesh("spot")
    sl = faces[: faces.shape[0] // 2]
    got = build_grid(verts, sl, force_resolution=(13, 9, 11), exact_overlap=exact,
                     device="cpu")
    want = jax_build_grid(verts, sl, force_resolution=(13, 9, 11), exact_overlap=exact)
    assert got.meta == tuple(want.meta)
    np.testing.assert_array_equal(got.host.cell_start, want.host.cell_start)
    np.testing.assert_array_equal(got.host.tri_ids, want.host.tri_ids)


def test_bin_triangles_cpu_dispatch_and_tri_box_overlap():
    """bin_triangles on CPU tensors runs the plain version (no launch),
    equal to the grid's CSR; the SAT test is the JAX package's on every
    candidate box of the soup; the kernel's wrapper refuses CPU tensors."""
    from ray_tracer_tpu.accel.grid import tri_box_overlap as jax_tri_box_overlap

    verts, faces = _soup()
    grid = build_grid(verts, faces, 3.0, 8, exact_overlap=True, device="cpu")
    h = grid.host
    vt, ft = torch.from_numpy(verts), torch.from_numpy(faces)
    before = native.bin_triangles_cuda.launches
    cs, ids = native.bin_triangles(vt, ft, h.lower, h.inv_width, h.width, grid.meta.n_voxels,
                                   True)
    assert native.bin_triangles_cuda.launches == before
    np.testing.assert_array_equal(cs.numpy(), h.cell_start)
    np.testing.assert_array_equal(ids.numpy(), h.tri_ids)
    # every (cell, triangle) pair of the 8^3 grid
    cells = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(8), indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float64)
    f = np.repeat(faces, cells.shape[0], axis=0)
    idx = np.tile(cells, (faces.shape[0], 1))
    v = verts.astype(np.float64)
    pad = np.broadcast_to(np.full(3, 1e-4), idx.shape)
    args = (v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], idx, idx + 1.0, pad)
    got = native.tri_box_overlap(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    np.testing.assert_array_equal(got.numpy(), jax_tri_box_overlap(*args))
    with pytest.raises(ValueError, match="CUDA"):
        native.bin_triangles_cuda(vt, ft, h.lower, h.inv_width, h.width, grid.meta.n_voxels,
                                  True)


def test_no_fallback_without_a_card():
    """Asking for the card where there is none raises; nothing falls back
    to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    verts, faces = _soup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_grid(verts, faces, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_grid(verts, faces)
