"""dtype="float64" in the port's Whitted render, against the JAX package
(tests/conftest.py turns x64 on, so the JAX side computes in float64).

* The camera's float64 batches (pinhole, spp subsamples, the thin lens)
  are bitwise JAX's.
* Kernel B's plain version walks float64 rays as `traverse_grid` does: the
  DDA setup and crossings in float64, t_min in float32, the Cramer solve in
  the det dtype; every record (any_pass, hit, t, tri_id, steps) bitwise
  op-by-op JAX's, faithful and production, both det dtypes, primary and
  shadow rays.
* The images are bitwise op-by-op JAX's (float64 colors) at 16x16: the
  faithful csr serial scene with float32 and float64 dets.
* Both waves refuse float64 as JAX's do: "auto" takes the bounce loop or
  the segment integrator, "on" raises ValueError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.core.rays import RayBatch as JaxRayBatch  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import camera as jax_camera  # noqa: E402
from ray_tracer_tpu.ops import traverse as jax_traverse  # noqa: E402
from ray_tracer_tpu.render import pathtrace as jax_pathtrace  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import CameraConfig, apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import camera, traverse  # noqa: E402
from ray_tracer_tpu_torch.render import pathtrace  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import (  # noqa: E402
    check_supported,
    prepare,
    render,
    shadow_rays_for,
    whitted_wave_eligible,
)


def _f64(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, dtype="float64",
                                                               **kw))


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_camera_float64_bitwise_vs_jax():
    from ray_tracer_tpu.config import CameraConfig as JaxCameraConfig

    for kw, spp in ((dict(width=13, height=9), 1), (dict(width=12, height=8), 3),
                    (dict(width=10, height=10, aperture=0.25, focus_distance=20.0), 2)):
        got = camera.camera_rays(CameraConfig(**kw), dtype=torch.float64, spp=spp,
                                 device="cpu")
        want = jax_camera.camera_rays(JaxCameraConfig(**kw), dtype=jnp.float64, spp=spp)
        for g, w in zip(got, want):
            _bitwise(g.numpy(), w)
        for s in range(spp * spp):
            sub = camera.camera_rays_subsample(CameraConfig(**kw), s, spp,
                                               dtype=torch.float64, device="cpu")
            wsub = jax_camera.camera_rays_subsample(JaxCameraConfig(**kw), s, spp,
                                                    dtype=jnp.float64)
            for g, w in zip(sub, wsub):
                _bitwise(g.numpy(), w)


@pytest.mark.parametrize("det", ["float32", "float64"])
def test_kernel_b_plain_on_f64_rays_bitwise_vs_jax(det):
    """Kernel B's plain version on float64 camera rays and their shadow
    rays, faithful (any t, walk to the end) and production (gated, early
    exit, any hit for shadows): the five records bitwise op-by-op JAX's,
    and the rays' DDA runs in float64 (not on float32 copies)."""
    cfg = scenes.serial_scene_config(16, 16)
    prep = prepare(cfg, device="cpu")
    jprep = jax_renderer.prepare(jax_scenes.serial_scene_config(16, 16))
    rays = camera.camera_rays(cfg.camera, dtype=torch.float64, device="cpu")
    tri9 = traverse.vertex_table(*prep.scene.triangle_soa())
    jv = jprep.scene.triangle_soa()
    eps = cfg.render.shadow_eps
    for mode, kw, skw in (("faithful", dict(t_gate=None), dict(t_gate=eps)),
                          ("production", dict(t_gate=0.0, early_exit=True),
                           dict(t_gate=eps, early_exit=True, stop_on_first_hit=True))):
        got = traverse.traverse_grid(rays, prep.grid.arrays, prep.grid.meta, tri9,
                                     det_dtype=det, **kw)
        jrays = JaxRayBatch(*(jnp.asarray(x.numpy()) for x in rays))
        with jax.disable_jit():
            want = jax_traverse.traverse_grid(jrays, jprep.grid.arrays, jprep.grid.meta, *jv,
                                              det_dtype=det, **kw)
        for name, g, w in zip(got._fields, got, want):
            _bitwise(g.numpy().astype(np.asarray(w).dtype), w)
        hit = got.any_pass if mode == "faithful" else got.hit
        poi = rays.at(torch.where(got.hit, got.t, torch.zeros_like(got.t)))
        srays = shadow_rays_for(cfg.render, prep.scene.light_pos, poi, hit)
        assert srays.orig.dtype == torch.float64
        sgot = traverse.traverse_grid(srays, prep.grid.arrays, prep.grid.meta, tri9,
                                      det_dtype=det, **skw)
        sj = JaxRayBatch(*(jnp.asarray(x.numpy()) for x in srays))
        with jax.disable_jit():
            swant = jax_traverse.traverse_grid(sj, jprep.grid.arrays, jprep.grid.meta, *jv,
                                               det_dtype=det, **skw)
        for g, w in zip(sgot, swant):
            _bitwise(g.numpy().astype(np.asarray(w).dtype), w)


def _jax_pair(make, family=None, **kw):
    cfg, jcfg = make(scenes), make(jax_scenes)
    if family:
        cfg, jcfg = apply_turbo(cfg, family), jax_apply_turbo(jcfg, family)
    return _f64(cfg, **kw), _f64(jcfg, **kw)


# the faithful csr frames; the turbo frames, spp, GI and the fit are in
# tests/test_torch_float64_paths.py
RENDER_CASES = {
    "csr_det32": (lambda m: m.serial_scene_config(16, 16), None, dict(det_dtype="float32")),
    "csr_det64": (lambda m: m.serial_scene_config(16, 16), None, dict(det_dtype="float64")),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_f64_render_bitwise_vs_jax_eager(case):
    make, family, kw = RENDER_CASES[case]
    cfg, jcfg = _jax_pair(make, family, **kw)
    img = render(prepare(cfg, device="cpu")).numpy()
    assert img.dtype == np.float64
    with jax.disable_jit():
        want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg)))
    _bitwise(img, want)
    assert (img.max(axis=-1) > 0).mean() > 0.05


def test_waves_refuse_f64_as_jax_does():
    parallel = apply_turbo(scenes.parallel_scene_config(8, 8), "parallel")
    jparallel = jax_apply_turbo(jax_scenes.parallel_scene_config(8, 8), "parallel")
    assert whitted_wave_eligible(parallel)
    jprep = jax_renderer.prepare(_f64(jparallel))
    assert not jax_renderer.whitted_wave_eligible(jprep)
    assert check_supported(_f64(parallel)) is False
    assert not whitted_wave_eligible(_f64(parallel))
    with pytest.raises(ValueError, match="ineligible"):
        jax_renderer.whitted_wave_eligible(jprep._replace(cfg=_f64(jparallel,
                                                                   whitted_wave="on")))
    with pytest.raises(ValueError, match="ineligible"):
        check_supported(_f64(parallel, whitted_wave="on"))
    gi = apply_turbo(dataclasses.replace(scenes.serial_scene_config(8, 8), render=dataclasses
                                         .replace(scenes.serial_scene_config(8, 8).render,
                                                  gi_samples=2)), "serial")
    jgi = jax_apply_turbo(dataclasses.replace(jax_scenes.serial_scene_config(8, 8),
                                              render=dataclasses.replace(
                                                  jax_scenes.serial_scene_config(8, 8).render,
                                                  gi_samples=2)), "serial")
    prep = prepare(_f64(gi), device="cpu")
    assert prep.cfg.render.gi_wave == "auto" and not prep.setup.gi_wave
    assert not jax_pathtrace.gi_wave_eligible(jax_renderer.prepare(_f64(jgi)))
    with pytest.raises(ValueError, match="ineligible"):
        pathtrace.gi_wave_eligible(_f64(gi, gi_wave="on"), prep.scene)
    with pytest.raises(ValueError, match="ineligible"):
        jax_pathtrace.gi_wave_eligible(jax_renderer.prepare(_f64(jgi, gi_wave="on")))
