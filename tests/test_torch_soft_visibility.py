"""Soft visibility in the port (mirrors tests/test_soft_visibility.py): the
hard image stays bitwise when the flag is off; with it on, the shadow
factor is sigmoid(margin / s) of the recorded blocker, continuous in the
blocker's vertices and checkable by finite differences, on kernel B's
walk (csr) and on kernel C's fused march (packed, persistent: the
blocker id rides the fused record).

The sigmoid is 1 / (1 + exp(-x)), jax.nn.sigmoid's formula, with torch's
exp: XLA's f32 exp is its own approximation, and the factor differs from
JAX's in the last bits on 8,265 of 200,000 inputs in [-25, 25] (4.1%; at
most 4 ulp, counted below), so the soft image is held to jitted JAX by
the 2-count rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu import config as jax_config  # noqa: E402
from ray_tracer_tpu.io.obj import MeshArrays as JaxMeshArrays  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch import config  # noqa: E402
from ray_tracer_tpu_torch.core import vecmath as vm  # noqa: E402
from ray_tracer_tpu_torch.io.obj import MeshArrays  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt import fit  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

SIZE = 24
PACKED = dict(traversal="packed", scheduler="persistent", fused_shadow=True)


def _blocker_parts(mesh_cls):
    floor = mesh_cls(
        verts=np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        uvs=np.zeros((1, 2), np.float32), uv_faces=np.zeros((2, 3), np.int32))
    blocker = mesh_cls(
        verts=np.array([[-0.7, 1.5, -0.7], [0.7, 1.5, -0.7], [0.0, 1.5, 0.9]], np.float32),
        faces=np.array([[0, 1, 2]], np.int32),
        uvs=np.zeros((1, 2), np.float32), uv_faces=np.zeros((1, 3), np.int32))
    return [(floor, 0), (blocker, 0)]


def _blocker_scene(soft: float, jax_side: bool = False, **render_kw):
    """A floor square and a small blocker triangle between it and the
    light; the camera looks at the shadowed floor."""
    pkg, mesh_cls, scn = ((jax_config, JaxMeshArrays, jax_scenes) if jax_side
                          else (config, MeshArrays, scenes))
    mat = pkg.MaterialConfig(base_color=(200.0, 200.0, 200.0), kd=2.0, ks=1.0,
                             spec_alpha=4.0, ka=0.2)
    light = pkg.LightConfig(position=(0.0, 6.0, 0.0), intensity=1.0)
    kw = {} if jax_side else {"device": "cpu"}
    scene = scn.scene_from_meshes(_blocker_parts(mesh_cls), [mat], light, **kw)
    cfg = pkg.SceneConfig(
        materials=(mat,),
        camera=pkg.CameraConfig(position=(0.0, 4.0, 3.5), target=(0, 0, 0), up=(0, 1, 0),
                                fov_degrees=50.0, width=SIZE, height=SIZE),
        light=light,
        render=pkg.RenderConfig(shading="parallel", faithful=False, max_bounces=0,
                                shadow_eps=1e-3, shadow_scale=0.5, ray_tile=64,
                                soft_visibility=soft, **render_kw))
    return (jax_renderer.prepare if jax_side else prepare)(cfg, scene=scene)


def test_soft_off_is_bit_identical_to_default():
    """soft_visibility=0 renders op-by-op JAX's hard image bit for bit, on
    the walk and the fused march alike; 0.05 changes it."""
    hard = render(_blocker_scene(0.0)).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_renderer.render(_blocker_scene(0.0, jax_side=True)))
    np.testing.assert_array_equal(hard.view(np.uint32), want.view(np.uint32))
    packed = render(_blocker_scene(0.0, **PACKED)).numpy()
    np.testing.assert_array_equal(packed.view(np.uint32), hard.view(np.uint32))
    assert (hard != render(_blocker_scene(0.05)).numpy()).any()


@pytest.mark.parametrize("render_kw", [{}, PACKED], ids=["csr", "packed_fused"])
def test_soft_shadow_factor_bounded(render_kw):
    hard = render(_blocker_scene(0.0, **render_kw)).numpy()
    soft = render(_blocker_scene(0.05, **render_kw)).numpy()
    assert soft.min() >= 0
    assert (soft >= hard - 1e-4).all()  # the soft image is never darker than the hard one


@pytest.mark.parametrize("render_kw", [{}, PACKED], ids=["csr", "packed_fused"])
def test_blocker_vertex_gradient_fd(render_kw):
    """d loss / d blocker-vertex z through the soft shadow against the
    central difference: the move shrinks the blocker in its plane, so no
    shadow ray flips between hit and miss."""
    prep = _blocker_scene(0.1, **render_kw)
    grid, meta = ((prep.packed.arrays, prep.packed.meta) if prep.packed is not None
                  else (prep.grid.arrays, prep.grid.meta))
    target = torch.zeros((SIZE, SIZE, 3))

    def loss_of(params):
        return fit.image_loss(params, prep.scene, grid, meta, prep.cfg, target)

    params = fit.split_scene(prep.scene)
    verts = params.verts.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_of(params._replace(verts=verts)), verts)
    analytic = float(g[6, 2])  # the blocker's third vertex (the floor has 4)
    eps = 2e-3

    def at(h):
        moved = params.verts.clone()
        moved[6, 2] += h
        with torch.no_grad():
            return float(loss_of(params._replace(verts=moved)))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert np.isfinite(analytic) and abs(analytic) > 0
    np.testing.assert_allclose(analytic, fd, rtol=0.05)


@pytest.mark.parametrize("render_kw", [{}, PACKED], ids=["csr", "packed_fused"])
def test_soft_image_vs_jax(render_kw):
    """The soft image against jitted JAX's: under 1% of pixels more than 2
    counts apart."""
    got = render(_blocker_scene(0.05, **render_kw)).numpy()
    want = np.asarray(jax_renderer.render(_blocker_scene(0.05, jax_side=True, **render_kw)))
    a, b = tonemap_u8(got).astype(int), tonemap_u8(want).astype(int)
    assert (np.abs(a - b).max(axis=-1) > 2).mean() < 0.01
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_sigmoid_parity_count():
    """The port's sigmoid against jax.nn.sigmoid on 200,000 seeded inputs in
    [-25, 25]: the differing inputs are counted (8,265 with torch 2.13's
    CPU exp, at most 4 ulp apart) and stay within rtol 1e-6; its backward
    is JAX's g * (ans * (1 - ans))."""
    x = np.random.default_rng(0).uniform(-25, 25, 200_000).astype(np.float32)
    got = vm.sigmoid(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    n = int((ulps > 0).sum())
    assert n < 0.05 * x.size, n
    assert ulps.max() <= 4
    np.testing.assert_allclose(got, want, rtol=1e-6)
    t = torch.from_numpy(x[:1000]).requires_grad_(True)
    (g,) = torch.autograd.grad(vm.sigmoid(t).sum(), t)
    ans = vm.sigmoid(t.detach()).numpy()
    np.testing.assert_array_equal(g.numpy(), ans * (1.0 - ans))


def test_path_tracer_ignores_the_soft_options():
    """The JAX path tracer never reads soft_visibility or soft_primary (they
    soften the Whitted loop's gradients): the port's path-traced image,
    through the GI wave and the segment integrator, is the same bits with
    them on."""
    from ray_tracer_tpu_torch.config import apply_turbo

    base = scenes.serial_scene_config(8, 8)
    base = dataclasses.replace(base, render=dataclasses.replace(
        base.render, faithful=False, gi_samples=2, gi_depth=1))
    for cfg in (apply_turbo(base, "serial"), base):
        soft = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, soft_visibility=0.1, soft_primary=0.05))
        want = render(prepare(cfg, device="cpu")).numpy()
        got = render(prepare(soft, device="cpu")).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
