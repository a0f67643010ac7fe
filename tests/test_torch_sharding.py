"""The port's ray-sharded renders (parallel/shard.py) on gloo groups of 2 and
4 CPU ranks (tests/torch_ranks.py), against the port on one device and the
JAX package's `render_sharded` on the 8-device CPU mesh (4 "rays" shards).

* render_sharded equals render() bitwise at both dealings (round-robin
  and contiguous) on every configuration of `torch_ranks.case_names()`:
  the faithful csr scene, spp 2, the packed persistent march, the Whitted
  wave (kernel E's plain version, sharded by queue arithmetic), the GI
  segment integrator and GI wave (kernel F's), the mirror furnace under an
  environment map, an environment map and an extra light on the Whitted
  render, and glass in the path tracer (tests/test_sharding.py:35, :427,
  test_whitted_wave.py:170, test_pathtrace.py:156, :939, :955,
  test_env.py:148, test_lights.py:96, test_dielectric.py:328).
* render_aovs and render_ao with mesh= equal the single-device buffers
  bitwise (tests/test_aov.py:130, :168).
* Against JAX's render_sharded: the csr scene and the Whitted wave by the
  rule the single-device tests hold jitted JAX to (u8 images more than 2
  counts apart on under 1% of pixels), the mirror furnace to JAX's own
  sharded tolerance (rtol 1e-6, atol 1e-4; both E exactly).
* intersect_brute_sharded over a 2 x 2 ("rays", "tris") mesh: hit and
  tri_id equal to the all-pairs sweep's, t to rtol 1e-6, and to JAX's
  sharded intersect (tests/test_sharding.py:44).
* factor_mesh and stride_permutation equal JAX's (tests/test_sharding.py:24).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.parallel import mesh as jax_mesh  # noqa: E402
from ray_tracer_tpu.parallel import shard as jax_shard  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.parallel.mesh import factor_mesh  # noqa: E402
from ray_tracer_tpu_torch.parallel.shard import stride_permutation  # noqa: E402
from ray_tracer_tpu_torch.render.aov import render_ao, render_aovs  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import render  # noqa: E402
from torch_ranks import E, case_names, case_prep, run_ranks  # noqa: E402

WORLDS = (2, 4)


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        got, want = got.view(np.uint32 if got.itemsize == 4 else np.uint64), want.view(
            np.uint32 if want.itemsize == 4 else np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of `sharded_renders` on 2 and on 4 ranks."""
    return {w: run_ranks("sharded_renders", w, tmp_path_factory.mktemp(f"w{w}"))[0]
            for w in WORLDS}


@pytest.fixture(scope="module")
def single():
    """Every case rendered on one device, by the port."""
    return {name: render(case_prep(name)).numpy() for name in case_names()}


def test_factor_mesh():
    for n in (1, 4, 7, 8, 12, 16):
        assert factor_mesh(n) == jax_mesh.factor_mesh(n)
    assert factor_mesh(8) == (4, 2) and factor_mesh(7) == (7, 1) and factor_mesh(16) == (4, 4)


def test_stride_permutation_is_permutation():
    for n, s in ((10, 4), (256, 4), (7, 3)):
        p = stride_permutation(n, s)
        assert sorted(p.tolist()) == list(range(n))
        np.testing.assert_array_equal(p, jax_shard.stride_permutation(n, s))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", case_names())
def test_render_sharded_equals_render(ranks, single, name, world):
    for balance in (False, True):
        _bitwise(ranks[world]["images"][name][balance], single[name])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["csr", "packed_persistent"])
def test_aovs_and_ao_sharded_equal_single(ranks, name, world):
    prep = case_prep(name)
    want = {k: v.numpy() for k, v in render_aovs(prep).items()}
    got = ranks[world][f"aovs_{name}"]
    assert sorted(got) == sorted(want)
    for k in want:
        _bitwise(got[k], want[k])
    _bitwise(ranks[world][f"ao_{name}"], render_ao(prep, samples=6, radius=1.0).numpy())


def _jax_prep(name):
    """The JAX package's counterpart of `case_prep(name)` (csr, the Whitted
    wave, the mirror furnace)."""
    import dataclasses

    import jax.numpy as jnp

    from ray_tracer_tpu.config import (CameraConfig, LightConfig, MaterialConfig, SceneConfig,
                                       apply_turbo)
    from ray_tracer_tpu.models import meshes
    from ray_tracer_tpu.models import scenes as js
    from ray_tracer_tpu.render.renderer import prepare

    def rep(cfg, **kw):
        return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))

    if name == "csr":
        scene, cfg = js.gradcheck_scene(16, 16)
        return prepare(rep(cfg, ray_tile=64), scene=scene)
    if name == "whitted_wave":
        return prepare(apply_turbo(js.parallel_scene_config(16, 16), "parallel"))
    mats = (MaterialConfig(base_color=(127.5,) * 3, km=1.0, reflective=True),)
    light = LightConfig(position=(0.0, 5.0, 0.0), intensity=0.0)
    scene = js.scene_from_meshes([(meshes.make_plane(extent=8.0, y=-1.0, density=2), 0)],
                                 mats, light)
    scene = scene._replace(env_image=jnp.full((4, 8, 3), E, jnp.float32))
    cfg = SceneConfig(materials=mats, light=light, camera=CameraConfig(
        position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=16, height=16))
    return prepare(rep(cfg, gi_samples=2, gi_depth=1, gi_wave="on", background=(7.0, 5.0, 3.0),
                       ray_tile=64, faithful=False, det_dtype="float32", traversal="packed",
                       scheduler="persistent", wave=64), scene=scene)


@pytest.mark.parametrize("name", ["csr", "whitted_wave", "gi_wave_mirror_env"])
def test_render_sharded_vs_jax(ranks, eight_device_mesh, name):
    want = np.asarray(jax_shard.render_sharded(_jax_prep(name), mesh=eight_device_mesh))
    got = ranks[4]["images"][name][True]
    if name == "gi_wave_mirror_env":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got, E, rtol=1e-6)
        return
    a, b = tonemap_u8(got), tonemap_u8(want)
    diff = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.01
    assert a.any()


def test_intersect_brute_sharded(ranks, eight_device_mesh, tiny_prep):
    from ray_tracer_tpu.ops.camera import camera_rays as jax_camera_rays
    from ray_tracer_tpu_torch.ops.camera import camera_rays
    from ray_tracer_tpu_torch.ops.intersect import intersect_brute

    got = ranks[4]["brute"]
    prep = case_prep("csr")
    v0, v1, v2 = prep.scene.triangle_soa()
    want = intersect_brute(camera_rays(prep.cfg.camera, device="cpu"), v0, v1, v2, t_lower=1e-4)
    h = want.hit.numpy()
    np.testing.assert_array_equal(got["hit"], h)
    np.testing.assert_array_equal(got["any_pass"], want.any_pass.numpy())
    np.testing.assert_array_equal(got["tri_id"][h], want.tri_id.numpy()[h])
    np.testing.assert_allclose(got["t"][h], want.t.numpy()[h], rtol=1e-6)
    jv = tiny_prep.scene.triangle_soa()
    jres = jax_shard.intersect_brute_sharded(jax_camera_rays(tiny_prep.cfg.camera), *jv,
                                             eight_device_mesh, t_lower=1e-4)
    np.testing.assert_array_equal(got["hit"], np.asarray(jres.hit))
    np.testing.assert_array_equal(got["tri_id"][h], np.asarray(jres.tri_id)[h])
    np.testing.assert_allclose(got["t"][h], np.asarray(jres.t)[h], rtol=1e-6)
