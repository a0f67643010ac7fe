"""Kernel C's plain version (ops/traverse_packed.march_plain, and
ops/persistent.persistent_trace on the CPU) against the JAX package's
packed march, on one shared packed grid.

The grid is the JAX prepare's packed grid of the turbo serial config,
carried into the port with `packed_from_numpy`.  Against op-by-op JAX
(`jax.disable_jit()`, every op rounding on its own as PyTorch's eager
ops do) hit, tri_id, in_shadow, t and steps are bitwise equal.  Against
jitted JAX, whose XLA:CPU fusion contracts the Cramer arithmetic
differently, the topology (hit, tri_id, in_shadow) is equal and t is
within rtol 4e-6 (about 32 ulps; the measured worst is 5.3e-7 at 32x32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.core.rays import RayBatch as JaxRays  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import persistent as jax_persistent  # noqa: E402
from ray_tracer_tpu.ops import traverse_packed as jax_tp  # noqa: E402
from ray_tracer_tpu.ops.camera import camera_rays as jax_camera_rays  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.accel.packed import packed_from_numpy  # noqa: E402
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.ops import traverse_packed as tp  # noqa: E402
from ray_tracer_tpu_torch.ops.persistent import persistent_trace  # noqa: E402

SIZE = 24
T_RTOL = 4e-6
# the serial shading's fused-march knobs (shadow eps 0.1 gate and mint,
# the away-from-light quirk)
FUSED = dict(shadow_gate=0.1, shadow_mint=0.1, serial_quirk=True)


def _carry(jprep):
    a = jprep.packed.arrays
    return packed_from_numpy(type(a)(*(np.asarray(x) for x in a)), jprep.packed.meta,
                             device="cpu")


@pytest.fixture(scope="module")
def turbo():
    """The turbo serial config's inline and blocks packed grids (JAX and
    port), its camera rays in both packages and the light."""
    cfg = jax_apply_turbo(jax_scenes.serial_scene_config(SIZE, SIZE), "serial")
    out = {}
    for layout in ("inline", "blocks"):
        c = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, grid_layout=layout))
        jprep = jax_renderer.prepare(c)
        assert jprep.packed.meta.inline == (layout == "inline")
        out[layout] = (jprep.packed.arrays, jprep.packed.meta, _carry(jprep))
    jrays = jax_camera_rays(cfg.camera, dtype=jnp.float32)
    rays = RayBatch(*(torch.from_numpy(np.array(x, np.float32)) for x in jrays))
    light = np.array(jprep.scene.light_pos, np.float32)
    return dict(grids=out, jrays=jrays, rays=rays, light=light)


def _jrays(rays: RayBatch):
    return JaxRays(*(jnp.asarray(x.numpy()) for x in rays))


def _bitwise(got, want, fields=("hit", "tri_id", "in_shadow", "steps")):
    for name in fields:
        if hasattr(want, name):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.t.numpy().view(np.uint32),
                                  np.asarray(want.t, np.float32).view(np.uint32), err_msg="t")


def _topology(got, want):
    for name in ("hit", "tri_id", "in_shadow"):
        if hasattr(want, name):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
    h = got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(want.t)[h], rtol=T_RTOL)


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any_hit"])
def test_traverse_packed_bitwise_vs_op_by_op_jax(turbo, any_hit):
    ja, jm, grid = turbo["grids"]["inline"]
    with jax.disable_jit():
        want = jax_tp.traverse_packed(turbo["jrays"], ja, jm, t_gate=0.0,
                                      stop_on_first_hit=any_hit)
    got = tp.traverse_packed(turbo["rays"], grid.arrays, grid.meta, t_gate=0.0,
                             stop_on_first_hit=any_hit)
    _bitwise(got, want)
    assert int(got.hit.sum()) > 50


def test_fused_shadow_bitwise_vs_op_by_op_jax(turbo):
    ja, jm, grid = turbo["grids"]["inline"]
    light = turbo["light"]
    with jax.disable_jit():
        want = jax_tp.traverse_packed_fused_shadow(turbo["jrays"], ja, jm, jnp.asarray(light),
                                                   primary_gate=0.0, **FUSED)
    got = tp.traverse_packed_fused_shadow(turbo["rays"], grid.arrays, grid.meta,
                                          torch.from_numpy(light), primary_gate=0.0, **FUSED)
    _bitwise(got, want, fields=("hit", "tri_id", "in_shadow", "shadow_tri_id", "steps"))
    assert int(got.in_shadow.sum()) > 0


def _persistent_kw(skip):
    return dict(wave=128, pump=4, fuse_shadow=True, t_gate=0.0, shadow_skip_dead=skip,
                shade_serial=True, need_steps=True, **FUSED)


@pytest.mark.parametrize("layout,skip", [("inline", True), ("blocks", False)])
def test_persistent_fused_bitwise_vs_op_by_op_jax(turbo, layout, skip):
    """A 128-lane JAX wave over 576 rays refills many times; every ray's
    record is the port's lock-step march's, bit for bit."""
    ja, jm, grid = turbo["grids"][layout]
    light = turbo["light"]
    kw = _persistent_kw(skip)
    with jax.disable_jit():
        want = jax_persistent.persistent_trace(turbo["jrays"], ja, jm, jnp.asarray(light), **kw)
    capped = torch.zeros((1,), dtype=torch.int32)
    got = persistent_trace(turbo["rays"], grid.arrays, grid.meta, torch.from_numpy(light),
                           capped_out=capped, **kw)
    _bitwise(got, want)
    assert int(capped) == 0 and int(got.hit.sum()) > 50


@pytest.mark.parametrize("skip", [True, False], ids=["skip_dead", "no_skip"])
@pytest.mark.parametrize("layout", ["inline", "blocks"])
def test_persistent_fused_vs_jitted_jax(turbo, layout, skip):
    ja, jm, grid = turbo["grids"][layout]
    light = turbo["light"]
    kw = _persistent_kw(skip)
    want = jax_persistent.persistent_trace(turbo["jrays"], ja, jm, jnp.asarray(light), **kw)
    got = persistent_trace(turbo["rays"], grid.arrays, grid.meta, torch.from_numpy(light), **kw)
    _topology(got, want)
    if skip:  # dead-shadow lanes report unshadowed
        noskip = persistent_trace(turbo["rays"], grid.arrays, grid.meta,
                                  torch.from_numpy(light), **_persistent_kw(False))
        assert int(got.in_shadow.sum()) < int(noskip.in_shadow.sum())
        assert not (got.in_shadow & ~noskip.in_shadow).any()


def test_persistent_queues_vs_jitted_jax(turbo):
    """The compacted, chord-ordered work queue serves the same rays with
    the same records; need_t off gives the 0/inf placeholder."""
    ja, jm, grid = turbo["grids"]["inline"]
    light = turbo["light"]
    jkeys = jax_tp.chord_keys(turbo["jrays"], ja)
    keys = tp.chord_keys(turbo["rays"], grid.arrays)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys, np.float32))
    kw = dict(_persistent_kw(True), compact=True)
    want = jax_persistent.persistent_trace(turbo["jrays"], ja, jm, jnp.asarray(light),
                                           order_keys=jkeys, **kw)
    got = persistent_trace(turbo["rays"], grid.arrays, grid.meta, torch.from_numpy(light),
                           order_keys=keys, **kw)
    _topology(got, want)
    bare = persistent_trace(turbo["rays"], grid.arrays, grid.meta, torch.from_numpy(light),
                            need_t=False, **dict(_persistent_kw(True), need_steps=False))
    assert torch.equal(bare.t, torch.where(bare.hit, 0.0, float("inf")))
    assert (bare.steps == 0).all() and (bare.shadow_tri_id == -1).all()


def test_degenerate_rays_bitwise_vs_op_by_op_jax(turbo):
    """A +inf-origin ray (a retired bounce lane), a zero direction, and
    origins on the grid's lower plane with axis-parallel directions (0*inf
    = NaN in the slab and box tests), through the nearest and the fused
    march."""
    ja, jm, grid = turbo["grids"]["inline"]
    lo = grid.arrays.lower.numpy()
    hi = grid.arrays.upper.numpy()
    mid = (lo + hi) / 2
    orig = np.array([
        [np.inf, np.inf, np.inf],
        mid,
        [lo[0], mid[1], mid[2]],  # on the x = lower plane, moving along y
        [mid[0], lo[1], mid[2]],  # on the y = lower plane, moving along x
        [mid[0], lo[1], lo[2]],   # on two lower planes, moving along x
        [lo[0], lo[1], mid[2] - 2.0],  # on two planes, moving along z
    ], np.float32)
    dirn = np.array([
        [0.6, 0.0, 0.8], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
    ], np.float32)
    rays = RayBatch.make(torch.from_numpy(orig), torch.from_numpy(dirn))
    with jax.disable_jit():
        want = jax_tp.traverse_packed(_jrays(rays), ja, jm, t_gate=0.0)
        wantf = jax_tp.traverse_packed_fused_shadow(
            _jrays(rays), ja, jm, jnp.asarray(turbo["light"]), primary_gate=0.0, **FUSED)
    got = tp.traverse_packed(rays, grid.arrays, grid.meta, t_gate=0.0)
    gotf = tp.traverse_packed_fused_shadow(rays, grid.arrays, grid.meta,
                                           torch.from_numpy(turbo["light"]),
                                           primary_gate=0.0, **FUSED)
    _bitwise(got, want)
    _bitwise(gotf, wantf)
    # the non-finite and the zero-direction rays never enter
    assert got.steps[:2].tolist() == [0, 0]
    assert (got.steps[2:] > 0).all()


def test_probe_chain_keeps_records(turbo):
    """probe_chain > 1 on the blocks layout changes step counts only."""
    _, _, grid = turbo["grids"]["blocks"]
    one = tp.traverse_packed(turbo["rays"], grid.arrays, grid.meta, t_gate=0.0)
    three = tp.traverse_packed(turbo["rays"], grid.arrays, grid.meta, t_gate=0.0,
                               probe_chain=3)
    for name in ("hit", "tri_id"):
        assert torch.equal(getattr(one, name), getattr(three, name))
    assert torch.equal(one.t.view(torch.int32), three.t.view(torch.int32))
    assert int(three.steps.sum()) < int(one.steps.sum())
    _, _, inline = turbo["grids"]["inline"]
    with pytest.raises(ValueError, match="blocks layout"):
        tp.traverse_packed(turbo["rays"], inline.arrays, inline.meta, probe_chain=2)


def test_stats_and_cap(turbo):
    """tested_out counts rows tested, touched_out marks header reads (1)
    and tested rows (2); a tiny step cap leaves rays capped."""
    _, _, grid = turbo["grids"]["inline"]
    r = turbo["rays"].count
    tested = torch.zeros((r,), dtype=torch.int32)
    touched = torch.zeros((grid.meta.n_blocks,), dtype=torch.int32)
    capped = torch.zeros((1,), dtype=torch.int32)
    res = tp.march_plain(turbo["rays"], grid.arrays, grid.meta, t_gate=0.0,
                         tested_out=tested, touched_out=touched, capped_out=capped)
    assert int(capped) == 0
    assert (tested[res.hit] > 0).all() and (tested <= res.steps).all()
    rows = (touched & 2) != 0
    assert int(rows.sum()) > 0 and int(((touched & 1) != 0).sum()) > 0
    assert (grid.arrays.slot_tri.view(-1, grid.meta.block_tris)[rows] >= 0).any(dim=1).all()
    tp.march_plain(turbo["rays"], grid.arrays, grid.meta, t_gate=0.0, max_steps=2,
                   capped_out=capped)
    assert int(capped) > 0


def test_march_cuda_refuses_cpu_tensors(turbo):
    _, _, grid = turbo["grids"]["inline"]
    before = tp.march_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tp.march_cuda(turbo["rays"], grid.arrays, grid.meta)
    tp.march(turbo["rays"].slice(0, 4), grid.arrays, grid.meta)
    assert tp.march_cuda.launches == before


def test_box_exit_remap_is_jnp_nan_to_num():
    """The box exit's `tf` goes through jnp.nan_to_num(x, nan=inf), whose
    sequential remap sends NaN to +inf and then to FLT_MAX (torch's
    nan_to_num would keep +inf); _slab_entry's remap keeps infinities."""
    x = np.array([np.nan, np.inf, -np.inf, 1.5, -0.0, 3e38], np.float32)
    want = np.asarray(jnp.nan_to_num(jnp.asarray(x), nan=jnp.inf))
    got = tp._nan_to_num_inf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == np.finfo(np.float32).max


def test_probe_cell_cast_decides_as_xla():
    """floor then XLA's saturating int32 cast (NaN -> 0): the port's
    clamped cast gives the same inside/outside decision and the same
    in-grid cells, for NaN, infinities and far values."""
    n = 7
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, -0.5, -1.0, 0.0, 6.99, 7.0, 7.5,
                  -1e-30, 2.5], np.float32)
    with jax.disable_jit():
        xla = np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32))
    got = tp._probe_cell(torch.from_numpy(x), torch.tensor(float(n))).numpy()
    inside_xla = (xla >= 0) & (xla < n)
    np.testing.assert_array_equal((got >= 0) & (got < n), inside_xla)
    np.testing.assert_array_equal(got[inside_xla], xla[inside_xla])
    assert got[0] == 0  # NaN lands in cell 0, inside, as in XLA


@pytest.mark.parametrize("block_tris", [1, 14])
def test_ties_take_the_first_slot_and_row(block_tris):
    """Three copies of one triangle: within a row the lowest slot wins
    (argmin), across rows (block_tris=1) only a strict < replaces the
    record; both equal op-by-op JAX and resolve to triangle 0."""
    from ray_tracer_tpu.accel.grid import build_grid as jax_build_grid
    from ray_tracer_tpu.accel.packed import pack_grid as jax_pack_grid

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [3, 3, 3], [4, 3, 3], [3, 4, 3]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 2], [0, 1, 2], [3, 4, 5]], np.int32)
    jgrid = jax_build_grid(verts, faces, resolution_multiplier=1.0, max_resolution=8)
    # blocks layout for one-triangle rows: the inline layout's overflow
    # index of cell 0 starts at 2 * n_cells (accel/packed.py:359-362 of
    # both packages), past the table when cell 0 itself overflows
    jp = jax_pack_grid(jgrid, verts, faces, block_tris=block_tris, inline=block_tris > 1)
    grid = packed_from_numpy(type(jp.arrays)(*(np.asarray(x) for x in jp.arrays)), jp.meta,
                             device="cpu")
    g = np.random.default_rng(5)
    xy = g.uniform(0.05, 0.45, (16, 2)).astype(np.float32)
    orig = np.concatenate([xy, np.full((16, 1), -2.0, np.float32)], axis=1)
    dirn = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (16, 1))
    rays = RayBatch.make(torch.from_numpy(orig), torch.from_numpy(dirn))
    with jax.disable_jit():
        want = jax_tp.traverse_packed(_jrays(rays), jp.arrays, jp.meta, t_gate=0.0)
    got = tp.traverse_packed(rays, grid.arrays, grid.meta, t_gate=0.0)
    _bitwise(got, want)
    assert got.hit.all() and (got.tri_id == 0).all()
