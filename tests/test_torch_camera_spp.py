"""The port's spp subsamples and thin-lens rays against the JAX package.

Camera rays, per subsample and with an aperture, are bitwise equal to
`ray_tracer_tpu/ops/camera.py` run op by op (`jax.disable_jit()`), at
float32 and float64, on cameras made from a numpy seed.  The spp render
of the serial scene through the bounce loop follows the image rule of
tests/test_torch_render_turbo.py against JAX's jitted render: more than 2
counts apart on under 1% of pixels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import CameraConfig as JaxCameraConfig  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import camera as jax_camera  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import CameraConfig  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import camera  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


def _cameras(seed=3, n=3, **extra):
    """(JAX config, port config) pairs of random look-at cameras with
    uneven image sides, so that no subpixel offset or aspect is exact."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kw = dict(
            position=tuple(float(x) for x in g.uniform(-8.0, 8.0, 3)),
            target=tuple(float(x) for x in g.uniform(-1.0, 1.0, 3)),
            up=(0.0, -1.0, 0.0),
            fov_degrees=float(g.uniform(25.0, 75.0)),
            width=int(g.integers(5, 13)),
            height=int(g.integers(5, 13)),
            **extra,
        )
        out.append((JaxCameraConfig(**kw), CameraConfig(**kw)))
    return out


def _assert_rays_equal(want, got):
    for name, w, g in zip(("orig", "dirn", "mint", "maxt"), want, got):
        np.testing.assert_array_equal(_bits(w), _bits(g.numpy()), err_msg=name)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("spp", [2, 3])
def test_camera_rays_spp_bitwise(spp, jdt, tdt):
    for jcfg, cfg in _cameras():
        with jax.disable_jit():
            want = jax_camera.camera_rays(jcfg, jdt, spp=spp)
        got = camera.camera_rays(cfg, tdt, spp=spp, device="cpu")
        assert got.count == cfg.width * cfg.height * spp * spp
        _assert_rays_equal(want, got)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_camera_rays_subsample_bitwise(jdt, tdt):
    spp = 3
    for jcfg, cfg in _cameras(seed=4, n=2, aperture=0.25):
        full = camera.camera_rays(cfg, tdt, spp=spp, device="cpu")
        hw = cfg.width * cfg.height
        for s in range(spp * spp):
            with jax.disable_jit():
                want = jax_camera.camera_rays_subsample(jcfg, s, spp, jdt)
            got = camera.camera_rays_subsample(cfg, s, spp, tdt, device="cpu")
            _assert_rays_equal(want, got)
            _assert_rays_equal([x[s * hw:(s + 1) * hw].numpy() for x in full], got)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("focus", [0.0, 4.5], ids=["focus_at_target", "focus_given"])
def test_lens_rays_bitwise(focus, jdt, tdt):
    for jcfg, cfg in _cameras(seed=5, aperture=0.25, focus_distance=focus):
        with jax.disable_jit():
            want = jax_camera.camera_rays(jcfg, jdt, spp=2)
        got = camera.camera_rays(cfg, tdt, spp=2, device="cpu")
        _assert_rays_equal(want, got)
        # the lens moves the origins off the eye point
        assert len(np.unique(got.orig.numpy(), axis=0)) == 4


def test_lens_needs_spp():
    """One subsample has no lens point: aperture with spp 1 is the
    pinhole batch, as in the JAX package."""
    (_, cfg), = _cameras(seed=6, n=1)
    lens = dataclasses.replace(cfg, aperture=0.25)
    pin = camera.camera_rays(cfg, device="cpu")
    got = camera.camera_rays(lens, device="cpu")
    for a, b in zip(pin, got):
        assert torch.equal(a, b)


def test_spp_render_matches_jitted_jax():
    """Serial scene, 16x16, spp 2, through the bounce loop on the CPU
    (accumulate_spp's sequential fold) against JAX's jitted render:
    more than 2 counts apart on under 1% of pixels."""
    size = 16
    cfg = scenes.serial_scene_config(size, size)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, spp=2))
    got = tonemap_u8(render(prepare(cfg, device="cpu")).numpy())
    jcfg = jax_scenes.serial_scene_config(size, size)
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(jcfg.render, spp=2))
    want = tonemap_u8(np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg))))
    diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.01
    assert (want.max(axis=-1) > 0).sum() > 20
