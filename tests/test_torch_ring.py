"""The port's geometry sharded by ring orbits (parallel/shard.py) on gloo
groups of 2 and 4 CPU ranks (tests/torch_ranks.py: `ring_renders`), against
the port on one device and the JAX package's ring on the 8-device CPU mesh,
on the same mesh shapes: world 2 one "tris" axis (the queries (1, 2)
("rays", "tris")), world 4 (2, 2) ("rays", "tris").

* render_sharded_geometry on every case of `torch_ranks.RING_CASES` (the
  JAX ring tests' cases on the gradcheck scene at 16x16: all-pairs and
  grid hops, mirror bounces, spp 2 with smooth normals and an environment
  map, a checker texture with an extra light and an area light, soft
  visibility and soft primary, GI on both hops, smooth GI): against the
  port's render() (GI: the segment integrator on the same camera rays) and
  against the JAX ring, to the JAX ring tests' own tolerances
  (tests/test_sharding.py:166-291, :451, :575, :626, :655-700); GI
  against JAX by the statistical rule of the port's GI tests (sampled
  directions differ in the last bit on ~1.3% of draws).
* The all-pairs ring image is the same bits at 1, 2 and 4 ranks: its t is
  a function of ray and triangle alone.
* intersect_ring_sharded: hit, tri_id and any_pass equal to the port's
  all-pairs sweep (t bitwise) and to JAX's ring (t to rtol 1e-6).
* trace_ring ids and flags equal to JAX's; render_aovs and render_ao with
  ring=True: ids and flags equal to the single-device buffers, floats to
  1e-5; trace_pixel(mesh=) the single-device record but steps = -1.
* `cli render --ring` writes render_sharded_geometry's PPM bytes.
* build_ring_shard (what the ring's entry points build when given no
  grids: each rank its own slice) is every rank's shard of
  build_ring_grids, byte for byte.

The ring train step is held in tests/test_torch_ring_fit.py.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import LightConfig as JaxLight  # noqa: E402
from ray_tracer_tpu.models.scenes import gradcheck_scene as jax_gradcheck  # noqa: E402
from ray_tracer_tpu.ops.camera import camera_rays as jax_camera_rays  # noqa: E402
from ray_tracer_tpu.parallel import shard as jax_shard  # noqa: E402
from ray_tracer_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.ops.camera import camera_rays  # noqa: E402
from ray_tracer_tpu_torch.ops.intersect import intersect_brute  # noqa: E402
from ray_tracer_tpu_torch.render.aov import render_ao, render_aovs  # noqa: E402
from ray_tracer_tpu_torch.render.debug import trace_pixel  # noqa: E402
from ray_tracer_tpu_torch.render.pathtrace import pathtrace_rays  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import render  # noqa: E402
from torch_ranks import (  # noqa: E402
    RING_CASES,
    RING_ENV,
    RING_EXTRA_LIGHT,
    one_rank_group,
    ring_case,
    run_groups,
)

WORLDS = (2, 4)
SOFT_PRIMARY = (0.1, 1e-3)  # test_sharding.py:626 (tanh amplifies last-ulp margins)
TOL = {"packed_soft": SOFT_PRIMARY, "brute_spp2_smooth_env": (1e-3, 1e-4)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's `ring_renders` on 2 and on 4 ranks (the groups at once)."""
    out = run_groups("ring_renders", WORLDS, lambda w: tmp_path_factory.mktemp(f"ring{w}"))
    return {w: res[0] for w, res in out.items()}


def _renders(ranks, world):
    return ranks[world]


def _jax_case(name):
    """RING_CASES' configuration `name`, prepared by the JAX package."""
    over, change = RING_CASES[name]
    scene, cfg = jax_gradcheck(16, 16)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, ray_tile=64,
                                                              faithful=False, **over))
    if change.get("reflective"):
        scene = scene._replace(materials=scene.materials._replace(
            reflective=jnp.asarray([False, True]), km=jnp.asarray([0.0, 0.6], jnp.float32)))
    if change.get("env"):
        scene = scene._replace(env_image=jnp.asarray(RING_ENV))
    if change.get("extra_light"):
        pos, li = RING_EXTRA_LIGHT
        cfg = dataclasses.replace(cfg, extra_lights=(JaxLight(pos, li),))
    return jax_renderer.prepare(cfg, scene=scene)


def _jax_meshes(world):
    two = jax_make_mesh(world, ("rays", "tris"), shape=(world // 2, 2))
    if world == 2:
        return jax_make_mesh(2, ("tris",), shape=(2,)), None, two
    return two, "rays", two


def _single(name):
    """The port's one-device image of the case: render(), or for GI the
    segment integrator on the camera rays the ring is fed."""
    prep = ring_case(name)
    if prep.cfg.render.gi_samples == 0:
        return render(prep).numpy()
    grid, meta = ((prep.packed.arrays, prep.packed.meta) if prep.packed is not None
                  else (prep.grid.arrays, prep.grid.meta))
    with torch.no_grad():
        out = pathtrace_rays(camera_rays(prep.cfg.camera, device="cpu"), prep.scene, grid, meta,
                             prep.cfg, dda=prep.dda)
    return out.reshape(16, 16, 3).numpy()


def _gi(name):
    return RING_CASES[name][0].get("gi_samples", 0) > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_render_vs_single(ranks, name, world):
    got = _renders(ranks, world)["images"][name]
    assert np.isfinite(got).all()
    atol, rtol = (5e-3, 1e-3) if _gi(name) else TOL.get(name, (1e-4, 1e-5))
    np.testing.assert_allclose(got, _single(name), atol=atol, rtol=rtol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_render_vs_jax(ranks, name, world):
    mesh, rays_axis, _ = _jax_meshes(world)
    want = np.asarray(jax_shard.render_sharded_geometry(_jax_case(name), mesh=mesh,
                                                        rays_axis=rays_axis))
    got = _renders(ranks, world)["images"][name]
    if _gi(name):
        assert (np.abs(got - want) <= 1e-3).all(axis=-1).mean() > 0.9
    else:
        atol, rtol = TOL.get(name, (1e-4, 1e-5))
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_all_pairs_ring_same_bits_at_every_world(ranks):
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from ray_tracer_tpu_torch.parallel.shard import render_sharded_geometry

    with one_rank_group():
        one = {name: render_sharded_geometry(ring_case(name), mesh=make_mesh(
            1, ("tris",), shape=(1,), devices="cpu"), rays_axis=None).numpy()
               for name in ("brute", "brute_bounces", "brute_spp2_smooth_env")}
    for name, want in one.items():
        for world in WORLDS:
            got = _renders(ranks, world)["images"][name]
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("world", WORLDS)
def test_intersect_ring_sharded(ranks, world):
    got = _renders(ranks, world)["intersect"]
    prep = ring_case("brute")
    want = intersect_brute(camera_rays(prep.cfg.camera, device="cpu"),
                           *prep.scene.triangle_soa(), t_lower=1e-4)
    hit = want.hit.numpy()
    np.testing.assert_array_equal(got["hit"], hit)
    np.testing.assert_array_equal(got["any_pass"], want.any_pass.numpy())
    np.testing.assert_array_equal(got["tri_id"][hit], want.tri_id.numpy()[hit])
    np.testing.assert_array_equal(got["t"][hit].view(np.uint32),
                                  want.t.numpy()[hit].view(np.uint32))
    mesh, rays_axis, _ = _jax_meshes(world)
    jprep = _jax_case("brute")
    jres = jax_shard.intersect_ring_sharded(jax_camera_rays(jprep.cfg.camera),
                                            *jprep.scene.triangle_soa(), mesh,
                                            rays_axis=rays_axis, t_lower=1e-4)
    for k in ("hit", "any_pass", "tri_id"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jres, k)))
    np.testing.assert_allclose(got["t"][hit], np.asarray(jres.t)[hit], rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["packed", "brute"])
def test_ring_queries(ranks, name, world):
    res = _renders(ranks, world)
    prep = ring_case(name)
    _, _, two = _jax_meshes(world)
    jprep = _jax_case(name)
    jb = jax_shard.trace_ring(jprep, jax_camera_rays(jprep.cfg.camera), two,
                              t_gate=jprep.cfg.render.shadow_eps)
    got = res[f"trace_{name}"]
    for k in ("hit", "tri_id", "mat"):
        np.testing.assert_array_equal(got[k], np.asarray(jb[k]), err_msg=k)
    hit = got["hit"]
    for k in ("t", "tv0", "tv1", "tv2"):
        np.testing.assert_allclose(got[k][hit], np.asarray(jb[k])[hit], rtol=1e-6, err_msg=k)
    single = {k: v.numpy() for k, v in render_aovs(prep).items()}
    for k, v in single.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(res[f"aovs_{name}"][k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(res[f"aovs_{name}"][k], v, err_msg=k)
    np.testing.assert_allclose(res[f"ao_{name}"], render_ao(prep, samples=6, radius=1.0).numpy(),
                               atol=1e-6)
    for rec, (x, y) in zip(res[f"pixel_{name}"], ((8, 8), (3, 12), (0, 0))):
        want = trace_pixel(prep, x, y)
        assert rec["steps"] == -1
        for k, v in want.items():
            if k == "steps":
                continue
            if isinstance(v, float):
                assert rec[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
            elif k in ("poi", "normal", "triangle"):
                np.testing.assert_allclose(rec[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                assert rec[k] == v, k


@pytest.mark.parametrize("world", WORLDS)
def test_own_ring_grid_is_its_shard_of_build_ring_grids(ranks, world):
    """build_ring_shard, each rank's own slice binned and the meta sizes
    shared, gives every rank its shard of build_ring_grids byte for byte
    (the gradcheck scene, and spot at the turbo settings)."""
    got = _renders(ranks, world)["own_grid_equal"]
    assert got == [[True] * world] * 2


@pytest.mark.parametrize("world", WORLDS)
def test_cli_render_ring_writes_the_ring_ppm(ranks, world):
    res = _renders(ranks, world)
    with open(res["cli_ppm"], "rb") as a, open(res["direct_ppm"], "rb") as b:
        assert a.read() == b.read()
