"""The port's packed grid (accel/packed.py) against the JAX package's.

One CSR grid per scene (the JAX build, carried into the port with
`grid_from_numpy`) is packed by both packages; `blocks`, `slot_tri`,
`cell_info` and the meta are byte-equal.  The JAX side builds its empty
boxes with the native builder, the port with kernel G's plain version
(accel/native.empty_boxes_plain), so these tests also pin the two growths
equal.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.accel.grid import build_grid as jax_build_grid  # noqa: E402
from ray_tracer_tpu.accel import packed as jax_packed  # noqa: E402
from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.accel import packed  # noqa: E402
from ray_tracer_tpu_torch.accel.grid import grid_from_numpy  # noqa: E402
from ray_tracer_tpu_torch.config import TUNED_KNOBS, apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render import renderer  # noqa: E402

# scene -> the TUNED_KNOBS family whose grid knobs it is packed at
FAMILIES = {"serial": "serial", "parallel": "parallel", "gradcheck": None}


def _scene_arrays(name):
    if name == "gradcheck":
        scene, _ = jax_scenes.gradcheck_scene(8, 8)
        return np.asarray(scene.verts), np.asarray(scene.faces)
    cfg = getattr(scenes, name + "_scene_config")(8, 8)
    verts, faces, *_ = scenes.scene_numpy_arrays(cfg)
    return verts, faces


@pytest.fixture(scope="module")
def grids():
    """Per scene: (verts, faces, JAX grid, the port's copy of it) at the
    turbo grid knobs of its family."""
    out = {}
    for name, family in FAMILIES.items():
        k = TUNED_KNOBS[family]
        verts, faces = _scene_arrays(name)
        jgrid = jax_build_grid(verts, faces, resolution_multiplier=k["rm"],
                               max_resolution=k["max_res"], exact_overlap=k["exact"])
        grid = grid_from_numpy(jgrid.host, jgrid.meta.n_voxels, device="cpu")
        out[name] = (verts, faces, jgrid, grid)
    return out


def _assert_byte_equal(got: packed.PackedGrid, want):
    assert tuple(got.meta) == tuple(want.meta)
    for field in ("blocks", "slot_tri", "cell_info", "lower", "upper", "width", "inv_width"):
        a = getattr(got.arrays, field).numpy()
        b = np.asarray(getattr(want.arrays, field))
        assert a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "blocks"])
@pytest.mark.parametrize("scene", sorted(FAMILIES))
def test_pack_grid_byte_equal_box_leap(grids, scene, inline):
    """The production leap (greedy maximal empty boxes), 14-triangle rows."""
    verts, faces, jgrid, grid = grids[scene]
    got = packed.pack_grid(grid, verts, faces, block_tris=14, inline=inline, leap="box")
    want = jax_packed.pack_grid(jgrid, verts, faces, block_tris=14, inline=inline, leap="box")
    _assert_byte_equal(got, want)
    assert got.meta.inline == inline


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "blocks"])
@pytest.mark.parametrize("leap,block_tris,scene", [
    ("cheb", 14, "serial"), ("cheb", 28, "gradcheck"), ("box", 28, "gradcheck"),
    ("cheb", 28, "parallel"),
])
def test_pack_grid_byte_equal_other_knobs(grids, scene, leap, block_tris, inline):
    """The Chebyshev leap and 28-triangle (256-lane) rows."""
    verts, faces, jgrid, grid = grids[scene]
    got = packed.pack_grid(grid, verts, faces, block_tris=block_tris, inline=inline, leap=leap)
    want = jax_packed.pack_grid(jgrid, verts, faces, block_tris=block_tris, inline=inline,
                                leap=leap)
    _assert_byte_equal(got, want)
    assert got.meta.row_lanes == (256 if block_tris == 28 else 128)


def test_greedy_empty_boxes_equal_jax():
    """The plain growth against the JAX package's builder on a random
    occupancy with clusters, at the default cap and at a cap of 3."""
    g = np.random.default_rng(7)
    occ = g.random((13, 17, 21)) < 0.04
    occ[4:7, 2:9, 10:12] = True
    want = jax_packed.greedy_empty_boxes(occ)
    got = packed.greedy_empty_boxes(occ)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (6,) + occ.shape
    np.testing.assert_array_equal(packed.greedy_empty_boxes(occ, cap=3),
                                  jax_packed.greedy_empty_boxes(occ, cap=3))


@pytest.mark.parametrize("scene", sorted(FAMILIES))
def test_layout_choices_agree_with_jax(grids, scene):
    verts, faces, jgrid, grid = grids[scene]
    assert renderer.choose_block_tris(grid) == jax_renderer.choose_block_tris(jgrid)
    for bt in (14, 28, 56):
        for budget in (1 << 20, 16 << 20, 64 << 20):
            assert (renderer.choose_inline_layout(grid, bt, budget)
                    == jax_renderer.choose_inline_layout(jgrid, bt, budget))


def test_prepare_builds_the_turbo_grid():
    """prepare() of the turbo serial config packs the JAX prepare's grid:
    the inline layout of 14-triangle rows, byte-equal."""
    cfg = apply_turbo(scenes.serial_scene_config(8, 8), "serial")
    prep = renderer.prepare(cfg, device="cpu")
    jprep = jax_renderer.prepare(jax_apply_turbo(jax_scenes.serial_scene_config(8, 8), "serial"))
    assert prep.packed.meta.inline and prep.packed.meta.block_tris == 14
    _assert_byte_equal(prep.packed, jprep.packed)


def test_decode_round_trip():
    """Extents packed by pack_extents decode back through both headers;
    an occupied word decodes to its row range."""
    g = np.random.default_rng(3)
    ext = g.integers(0, 32, (6, 50)).astype(np.int32)
    words = packed.pack_extents(ext)
    lo_want = np.stack([ext[0], ext[2], ext[4]], -1)
    hi_want = np.stack([ext[1], ext[3], ext[5]], -1)
    info = torch.from_numpy((words | np.uint32(1 << 31)).view(np.int32))
    first, nblk, lo, hi = packed.decode_cell_info(info)
    assert (nblk == 0).all()
    np.testing.assert_array_equal(lo.numpy(), lo_want)
    np.testing.assert_array_equal(hi.numpy(), hi_want)
    occ = np.array([5 | (3 << 21), 2097151 | (63 << 21)], np.uint32)
    first, nblk, _, _ = packed.decode_cell_info(torch.from_numpy(occ.view(np.int32)))
    assert first.tolist() == [5, 2097151] and nblk.tolist() == [3, 63]
    row = np.zeros((50, 128), np.float32)
    row.view(np.int32)[:, -2] = words.view(np.int32)
    row.view(np.int32)[:, -1] = np.arange(50) % 7
    h0, n, lo, hi = packed.decode_inline_header(torch.from_numpy(row))
    np.testing.assert_array_equal(h0.numpy(), words.view(np.int32))
    np.testing.assert_array_equal(n.numpy(), np.arange(50) % 7)
    np.testing.assert_array_equal(lo.numpy(), lo_want)
    np.testing.assert_array_equal(hi.numpy(), hi_want)


def test_packed_from_numpy_carries_the_jax_grid(grids):
    verts, faces, jgrid, _ = grids["gradcheck"]
    want = jax_packed.pack_grid(jgrid, verts, faces, inline=False)
    got = packed.packed_from_numpy(
        jax_packed.PackedGridArrays(*(np.asarray(x) for x in want.arrays)), want.meta,
        device="cpu")
    _assert_byte_equal(got, want)


def test_later_slice_options_raise(grids):
    """as_numpy (the ring's host build) is served: numpy arrays, the device
    pack's bytes (tests/test_torch_ring_grids.py holds them to JAX's);
    pad_meta stays refused."""
    verts, faces, _, grid = grids["gradcheck"]
    host = packed.pack_grid(grid, verts, faces, as_numpy=True)
    meta = packed.pack_grid(grid, verts, faces).meta
    dev = packed.pack_grid(grid, verts, faces)
    assert tuple(host.meta) == tuple(meta)
    for field in host.arrays._fields:
        a = getattr(host.arrays, field)
        assert isinstance(a, np.ndarray)
        assert a.tobytes() == getattr(dev.arrays, field).numpy().tobytes(), field
    with pytest.raises(NotImplementedError):
        packed.pack_grid(grid, verts, faces, pad_meta=meta)
