"""Kernel B's plain version (the lock-step CSR DDA) against the JAX
package's `traverse_grid`, on one shared grid.

Against op-by-op JAX (`jax.disable_jit()`, every op rounding on its own as
PyTorch's eager ops do) all five TraceResult fields are bitwise equal.
Against jitted JAX, whose XLA:CPU fusion rounds the f32 entry setup and
the Cramer arithmetic differently, the f64 path keeps the topology
(any_pass, hit, tri_id, steps) equal and t within rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.accel.grid import build_grid as jax_build_grid  # noqa: E402
from ray_tracer_tpu.core.rays import RayBatch as JaxRays  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops.traverse import traverse_grid as jax_traverse_grid  # noqa: E402
from ray_tracer_tpu_torch.accel.grid import grid_from_numpy  # noqa: E402
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops.camera import camera_rays  # noqa: E402
from ray_tracer_tpu_torch.ops.traverse import traverse_grid, vertex_table  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import shadow_rays_for  # noqa: E402

MODES = {
    # faithful serial regime: no gate, full walk
    "faithful": dict(t_gate=None, early_exit=False, stop_on_first_hit=False),
    # production regime: gate + early exit (+ first-hit stop for shadows)
    "production": dict(t_gate=0.0, early_exit=True, stop_on_first_hit=False),
}


@pytest.fixture(scope="module")
def serial32():
    """One grid (the JAX numpy build) carried into the port, the serial
    scene's 32x32 camera rays and their shadow rays from the faithful
    primary hits."""
    cfg = scenes.serial_scene_config(32, 32)
    verts, faces, *_ = scenes.scene_numpy_arrays(cfg)
    jgrid = jax_build_grid(verts, faces, use_native=False)
    grid = grid_from_numpy(jgrid.host, jgrid.meta.n_voxels, device="cpu")
    v = torch.from_numpy(verts)[torch.from_numpy(faces).long()]
    tri9 = vertex_table(v[:, 0], v[:, 1], v[:, 2])
    prim = camera_rays(cfg.camera, device="cpu")
    res = traverse_grid(prim, grid.arrays, grid.meta, tri9, det_dtype="float64")
    hit = res.any_pass
    poi = torch.where(hit[:, None], prim.at(torch.where(res.hit, res.t, torch.zeros_like(res.t))),
                      torch.zeros_like(prim.orig))
    shadow = shadow_rays_for(cfg.render, torch.tensor(cfg.light.position, dtype=torch.float32),
                             poi, hit)
    assert int(hit.sum()) > 100
    return dict(jgrid=jgrid, grid=grid, tri9=tri9, verts=verts, faces=faces,
                rays={"primary": prim, "shadow": shadow})


def _jax_trace(s, rays, det_dtype, kw):
    v = jnp.asarray(s["verts"])[jnp.asarray(s["faces"])]
    jr = JaxRays(*(jnp.asarray(x.numpy()) for x in rays))
    return jax_traverse_grid(jr, s["jgrid"].arrays, s["jgrid"].meta,
                             v[:, 0], v[:, 1], v[:, 2], det_dtype=det_dtype, **kw)


def _kw(mode, which):
    kw = dict(MODES[mode])
    if which == "shadow":
        kw["t_gate"] = 0.1  # the serial shadow eps
        kw["stop_on_first_hit"] = mode == "production"
    return kw


@pytest.mark.parametrize("which", ["primary", "shadow"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("det_dtype", ["float32", "float64"])
def test_plain_dda_bitwise_vs_op_by_op_jax(serial32, det_dtype, mode, which):
    s = serial32
    rays = s["rays"][which]
    kw = _kw(mode, which)
    with jax.disable_jit():
        want = _jax_trace(s, rays, det_dtype, kw)
    got = traverse_grid(rays, s["grid"].arrays, s["grid"].meta, s["tri9"],
                        det_dtype=det_dtype, **kw)
    for name in ("any_pass", "hit", "tri_id", "steps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.t.numpy().view(np.uint32),
                                  np.asarray(want.t).view(np.uint32))
    assert got.hit.any()


@pytest.mark.parametrize("which", ["primary", "shadow"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_dda_f64_vs_jitted_jax(serial32, mode, which):
    """Topology equal; t to rtol 1e-9 (f64 determinants, fused
    differently under jit, then rounded to f32: at most an ulp apart)."""
    s = serial32
    rays = s["rays"][which]
    kw = _kw(mode, which)
    want = _jax_trace(s, rays, "float64", kw)
    got = traverse_grid(rays, s["grid"].arrays, s["grid"].meta, s["tri9"],
                        det_dtype="float64", **kw)
    for name in ("any_pass", "hit", "tri_id", "steps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    h = got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(want.t)[h], rtol=1e-9)


def test_tested_count_and_dead_lanes(serial32):
    """Rays with +inf origins and an all-negative direction pass the slab
    test with NaN entry points: the walk takes one step and finds nothing,
    as in the JAX loop; tested_out counts the triangles each ray tested."""
    s = serial32
    r = 4
    rays = RayBatch.make(torch.full((r, 3), float("inf")),
                         torch.tensor([[-0.5, -0.5, -0.7071]] * 2 + [[0.5, -0.5, 0.7071]] * 2))
    tested = torch.zeros((r,), dtype=torch.int32)
    got = traverse_grid(rays, s["grid"].arrays, s["grid"].meta, s["tri9"], tested_out=tested)
    with jax.disable_jit():
        want = _jax_trace(s, rays, "float32", {})
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    assert got.steps.tolist() == [1, 1, 0, 0]
    assert not got.hit.any() and not got.any_pass.any()
    prim = s["rays"]["primary"]
    tested = torch.zeros((prim.count,), dtype=torch.int32)
    res = traverse_grid(prim, s["grid"].arrays, s["grid"].meta, s["tri9"], tested_out=tested)
    assert (tested[res.steps == 0] == 0).all()
    assert (tested[res.any_pass] > 0).all()  # a pass needs a tested triangle
