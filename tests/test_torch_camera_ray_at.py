"""The port's `camera_ray_at` and kernel E's camera launch values against
the JAX package and the port's own batch.

`ops/camera.camera_ray_at` makes the rays of arbitrary flat indices
s*H*W + y*W + x; on shuffled indices it is bitwise equal to
`ray_tracer_tpu/ops/camera.py:camera_ray_at` run op by op
(`jax.disable_jit()`) and to the same rows of the port's `camera_rays`,
at spp 1, 2 and 3 (odd spp, as tests/test_camera.py checks JAX), with
and without the thin lens, on cameras made from a numpy seed.
`camera_launch` holds the values kernel E makes its rays from
(csrc/camera.cuh): the basis of `camera_basis` on the CPU, the f32
scalars and the subsample table of the batch's Python floats.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import CameraConfig as JaxCameraConfig  # noqa: E402
from ray_tracer_tpu.ops import camera as jax_camera  # noqa: E402
from ray_tracer_tpu_torch.config import CameraConfig  # noqa: E402
from ray_tracer_tpu_torch.ops import camera  # noqa: E402

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
LENS = [dict(), dict(aperture=0.3, focus_distance=7.5), dict(aperture=0.2)]


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


def _cameras(seed, n=2, **extra):
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
            width=int(g.integers(5, 19)),
            height=int(g.integers(5, 19)),
            **extra,
        )
        out.append((JaxCameraConfig(**kw), CameraConfig(**kw)))
    return out


def _shuffled(cfg, spp, seed):
    n = cfg.width * cfg.height * spp * spp
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


def _assert_rays_equal(want, got):
    for name, w, g in zip(("orig", "dirn", "mint", "maxt"), want, got):
        np.testing.assert_array_equal(_bits(w), _bits(g.numpy()), err_msg=name)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("lens", range(len(LENS)), ids=["pinhole", "lens", "lens_target"])
@pytest.mark.parametrize("spp", [1, 2, 3])
def test_camera_ray_at_bitwise_vs_op_by_op_jax(spp, lens, jdt, tdt):
    for k, (jcfg, cfg) in enumerate(_cameras(10 * spp + lens, **LENS[lens])):
        idx = _shuffled(cfg, spp, seed=k)
        with jax.disable_jit():
            want = jax_camera.camera_ray_at(jcfg, jnp.asarray(idx), jdt, spp=spp)
        got = camera.camera_ray_at(cfg, torch.from_numpy(idx), tdt, spp=spp, device="cpu")
        assert got.count == idx.shape[0] and got.orig.dtype == tdt
        _assert_rays_equal(want, got)


@pytest.mark.parametrize("lens", range(len(LENS)), ids=["pinhole", "lens", "lens_target"])
@pytest.mark.parametrize("spp", [1, 2, 3])
def test_camera_ray_at_equals_the_batch(spp, lens):
    """The rows of camera_rays that the shuffled indices name, bit for
    bit: what kernel E's in-kernel rays are held to on the card."""
    for k, (_, cfg) in enumerate(_cameras(100 + 10 * spp + lens, n=3, **LENS[lens])):
        idx = torch.from_numpy(_shuffled(cfg, spp, seed=k)).long()
        batch = camera.camera_rays(cfg, spp=spp, device="cpu")
        got = camera.camera_ray_at(cfg, idx, spp=spp, device="cpu")
        _assert_rays_equal([x[idx].numpy() for x in batch], got)
        if LENS[lens] and spp > 1:  # the lens moves the origins off the eye
            assert not torch.equal(got.orig, got.orig[:1].expand_as(got.orig))


@pytest.mark.parametrize("spp", [1, 2, 3])
def test_subsample_table_holds_the_batch_constants(spp):
    (_, cfg), = _cameras(7, n=1, aperture=0.25)
    tab = camera.subsample_table(cfg, spp, device="cpu")
    assert tab.shape == (spp * spp, 4) and tab.dtype == torch.float32
    for s in range(spp * spp):
        ox, oy = camera._subpixel_offset(s, spp)
        lens = camera._lens_offset(cfg, s, spp) or (0.0, 0.0)
        want = np.asarray([ox, oy, *lens], np.float32)
        np.testing.assert_array_equal(_bits(tab[s].numpy()), _bits(want))


@pytest.mark.parametrize("spp", [1, 3])
def test_camera_launch_values(spp):
    """Kernel E's camera values: the CPU basis as f32 floats, the scalars
    narrowed as the batch narrows them, the lens flag, the table."""
    for jcfg, cfg in _cameras(11, aperture=0.25):
        launch = camera.camera_launch(cfg, spp, device="cpu")
        pos, u, v, w, fd = camera.camera_basis(cfg, device="cpu")
        assert launch.basis == tuple(tuple(t.tolist()) for t in (pos, u, v, w))
        f32 = np.float32
        want = (fd, cfg.width / cfg.height, cfg.width / 2.0, cfg.height / 2.0, cfg.width,
                cfg.height, math.dist(cfg.position, cfg.target))
        assert launch.scalars == tuple(float(f32(x)) for x in want)
        assert launch.lens == (spp > 1)
        assert torch.equal(launch.table, camera.subsample_table(cfg, spp, device="cpu"))
        # the basis equals the JAX package's bit for bit
        with jax.disable_jit():
            jb = jax_camera.camera_basis(jcfg)
        for got, want in zip(launch.basis, jb[:4]):
            np.testing.assert_array_equal(_bits(np.asarray(got, np.float32)), _bits(want))
