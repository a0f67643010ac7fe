"""Camera rays and the Cramer solve of the port against op-by-op JAX.

"Op-by-op" is the JAX function run outside `jit` (under
`jax.disable_jit()`), where every array op rounds on its own as PyTorch's
eager ops do; the comparisons are bitwise.  (Under `jit`, XLA:CPU fuses
the arithmetic differently, so jitted values are not a bitwise target.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import camera as jax_camera  # noqa: E402
from ray_tracer_tpu.ops import intersect as jax_intersect  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import camera, intersect  # noqa: E402

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("name", ["serial", "parallel"])
def test_camera_rays_bitwise(name, jdt, tdt):
    mk = f"{name}_scene_config"
    with jax.disable_jit():
        want = jax_camera.camera_rays(getattr(jax_scenes, mk)(32, 32).camera, jdt)
    got = camera.camera_rays(getattr(scenes, mk)(32, 32).camera, tdt, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(w), _bits(g.numpy()))


def _pairs(seed=7, n=20000):
    """Random (ray, triangle) pairs; some rays start on a vertex, some run
    parallel to their triangle, so degenerate determinants occur."""
    g = np.random.default_rng(seed)
    o = (g.normal(size=(n, 3)) * 3).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    v0, v1, v2 = (g.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    o[:100] = v0[:100]
    d[100:200] = v1[100:200] - v0[100:200]
    valid = g.random(n) < 0.8
    return o, d, v0, v1, v2, valid


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_cramer_tbg_bitwise(jdt, tdt):
    o, d, v0, v1, v2, _ = _pairs()
    with jax.disable_jit():
        want = jax_intersect.cramer_tbg(
            *(jnp.asarray(x) for x in (o, d, v0, v1, v2)), det_dtype=jdt)
    got = intersect.cramer_tbg(*(torch.from_numpy(x) for x in (o, d, v0, v1, v2)),
                               det_dtype=tdt)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(w), _bits(g.numpy()))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_cramer_t_safe_bitwise(jdt, tdt):
    o, d, v0, v1, v2, valid = _pairs(seed=8)
    o[np.flatnonzero(~valid)[:50]] = np.inf  # retired lanes carry inf origins
    with jax.disable_jit():
        want = jax_intersect.cramer_t_safe(
            *(jnp.asarray(x) for x in (o, d, v0, v1, v2, valid)), det_dtype=jdt)
    got = intersect.cramer_t_safe(*(torch.from_numpy(x) for x in (o, d, v0, v1, v2)),
                                  torch.from_numpy(valid), det_dtype=tdt)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    assert np.isfinite(got.numpy()[~valid]).all()
