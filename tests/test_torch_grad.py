"""Gradients through the port's differentiable render against the JAX
package (mirrors tests/test_grad.py).

* On the gradcheck scene at 16x16 (the `tiny_prep` scene), the loss and
  the gradients of kd, base_color, ka, light_pos and verts against eager
  `jax.grad` of the JAX `image_loss`: per leaf rtol 1e-4, atol
  1e-6 * max|g| (about 3e-6 relative measured; the loss is bitwise).
* The forward colors under autograd are bitwise op-by-op JAX's, and
  bitwise the port's own no-grad render.
* The single-triangle vertex gradient: autodiff against finite
  differences, and against eager jax.grad.
* soft_primary: the silhouette vertex gradient matches finite
  differences (the fade is 0 at the edge), against eager jax.grad too;
  the softening touches silhouettes only, and the soft image is within
  the 2-count rule of jitted JAX's.
* `cramer_t_safe` and `cramer_bg_safe` under autograd: finite gradients
  on missed lanes (inf origins), ray-parallel triangles (A == 0) and
  degenerate ones, equal to jax.grad's to rtol 1e-5 elsewhere.
* The XLA-form tanh is bitwise jnp.tanh on 200,000 seeded inputs in
  [0, 25] (and [-8, 8]); its backward is JAX's rule.
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
from ray_tracer_tpu.opt import fit as jax_fit  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch import config  # noqa: E402
from ray_tracer_tpu_torch.core import vecmath as vm  # noqa: E402
from ray_tracer_tpu_torch.io.obj import MeshArrays  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt import fit  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

SIZE = 16
LEAVES = ("kd", "base_color", "ka", "light_pos", "verts")


def _grads(loss_of, params, fields):
    """(loss, {field: gradient}) of the port's loss over the named leaves."""
    leaves = {f: getattr(params, f).detach().clone().requires_grad_(True) for f in fields}
    loss = loss_of(params._replace(**leaves))
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss.detach()), {f: (torch.zeros_like(leaves[f]) if g is None else g).numpy()
                                  for f, g in zip(fields, gs)}


def _port_loss(prep, target):
    def loss_of(params):
        return fit.image_loss(params, prep.scene, prep.grid.arrays, prep.grid.meta, prep.cfg,
                              torch.from_numpy(target))
    return loss_of


def _jax_loss(prep, target):
    def loss_of(params):
        return jax_fit.image_loss(params, prep.scene, prep.grid.arrays, prep.grid.meta,
                                  prep.cfg, jnp.asarray(target))
    return loss_of


def _assert_leaf(got, want, field):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * float(np.abs(want).max()),
                               err_msg=field)


@pytest.fixture(scope="module")
def gradcheck():
    """The gradcheck scene at 16x16 in both packages, its random target,
    and eager jax.grad of the JAX image_loss (loss and every leaf)."""
    scene, cfg = scenes.gradcheck_scene(SIZE, SIZE, device="cpu")
    jscene, jcfg = jax_scenes.gradcheck_scene(SIZE, SIZE)
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(jcfg.render, ray_tile=64))
    prep, jprep = prepare(cfg, scene=scene), jax_renderer.prepare(jcfg, scene=jscene)
    target = np.random.default_rng(0).uniform(0, 80, size=(SIZE, SIZE, 3)).astype(np.float32)
    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(_jax_loss(jprep, target))(
            jax_fit.split_scene(jprep.scene))
    return prep, jprep, target, float(jloss), jgrads


@pytest.mark.parametrize("field", LEAVES)
def test_gradient_matches_eager_jax(gradcheck, field):
    prep, _, target, jloss, jgrads = gradcheck
    loss, grads = _grads(_port_loss(prep, target), fit.split_scene(prep.scene), (field,))
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    want = np.asarray(getattr(jgrads, field))
    assert np.isfinite(grads[field]).all() and np.abs(want).max() > 0
    _assert_leaf(grads[field], want, field)


def test_forward_under_autograd_is_bitwise(gradcheck):
    """The colors the loss sees, with every leaf requiring grad, are the
    op-by-op JAX colors bit for bit, and the port's render()."""
    prep, jprep, _, _, _ = gradcheck
    params = fit.split_scene(prep.scene)
    params = params._replace(**{f: getattr(params, f).clone().requires_grad_(True)
                                for f in LEAVES})
    colors = fit._colors(params, prep.scene, prep.grid.arrays, prep.grid.meta, prep.cfg,
                         None, None)
    assert colors.requires_grad
    got = colors.detach().numpy()
    from ray_tracer_tpu.ops.camera import camera_rays as jax_camera_rays

    with jax.disable_jit():
        want = np.asarray(jax_fit._render_flat(
            jax_fit.split_scene(jprep.scene), jprep.scene, jprep.grid.arrays, jprep.grid.meta,
            jprep.cfg, jax_camera_rays(jprep.cfg.camera, dtype=jnp.float32)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    img = render(prep).numpy().reshape(-1, 3)
    np.testing.assert_array_equal(got.view(np.uint32), img.view(np.uint32))


def _one_triangle(verts, mat_kw, light_pos, cam_kw, size, **render_kw):
    """A one-triangle scene in both packages -> (port prep, JAX prep)."""
    out = []
    for pkg, mesh_cls, scn in ((config, MeshArrays, scenes), (jax_config, JaxMeshArrays,
                                                              jax_scenes)):
        tri = mesh_cls(verts=np.asarray(verts, np.float32), faces=np.array([[0, 1, 2]], np.int32),
                       uvs=np.zeros((1, 2), np.float32), uv_faces=np.zeros((1, 3), np.int32))
        mat = pkg.MaterialConfig(**mat_kw)
        light = pkg.LightConfig(position=light_pos, intensity=1.0)
        kw = {"device": "cpu"} if pkg is config else {}
        scene = scn.scene_from_meshes([(tri, 0)], [mat], light, **kw)
        cfg = pkg.SceneConfig(
            materials=(mat,), camera=pkg.CameraConfig(width=size, height=size, **cam_kw),
            light=light,
            render=pkg.RenderConfig(shading="parallel", faithful=False, max_bounces=0,
                                    shadow_eps=1e-3, shadow_scale=0.5, **render_kw))
        out.append((prepare if pkg is config else jax_renderer.prepare)(cfg, scene=scene))
    return out


def _fd_check(loss_of, params, field, idx, eps, rtol):
    """Autodiff against the central difference along one coordinate."""
    _, grads = _grads(loss_of, params, (field,))
    analytic = float(grads[field][idx])
    val = getattr(params, field)

    def at(h):
        moved = val.clone()
        moved[idx] += h
        with torch.no_grad():
            return float(loss_of(params._replace(**{field: moved})))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert np.isfinite(analytic)
    np.testing.assert_allclose(analytic, fd, rtol=rtol, atol=1e-7)
    return grads[field]


def _vs_jax_vertex_grad(jprep, target, got):
    with jax.disable_jit():
        want = np.asarray(jax.grad(_jax_loss(jprep, target))(
            jax_fit.split_scene(jprep.scene)).verts)
    _assert_leaf(got, want, "verts")


def test_vertex_gradient_single_triangle():
    """Moving a vertex changes t, the normal and the shading; no topology
    change is possible on one triangle."""
    prep, jprep = _one_triangle(
        [[-2, -0.5, -2], [2, -0.5, -2], [0, -0.5, 3]],
        dict(base_color=(200.0, 100.0, 50.0), kd=2.0, ks=3.0, spec_alpha=4.0, ka=0.2),
        (1.0, 4.0, 1.0), dict(position=(0, 2.5, 0.5), target=(0, -1, 0), up=(0, 0, 1),
                              fov_degrees=60.0), 8)
    target = np.zeros((8, 8, 3), np.float32)
    loss_of, params = _port_loss(prep, target), fit.split_scene(prep.scene)
    _fd_check(loss_of, params, "verts", (2, 1), eps=1e-3, rtol=2e-2)
    g = _fd_check(loss_of, params, "verts", (0, 0), eps=1e-3, rtol=2e-2)
    _vs_jax_vertex_grad(jprep, target, g)


def test_silhouette_vertex_gradient_fd():
    """soft_primary=0.08 fades each hit toward the background by
    tanh(margin / s), 0 exactly at the edge: a vertex that drags the
    silhouette across pixel centers has autodiff == finite differences."""
    prep, jprep = _one_triangle(
        [[-1.2, -1.0, 0.0], [1.2, -1.0, 0.0], [0.0, 1.2, 0.0]],
        dict(base_color=(220.0, 160.0, 40.0), kd=2.0, ks=1.0, spec_alpha=4.0, ka=0.3),
        (0.0, 0.0, 6.0), dict(position=(0.0, 0.0, 4.0), target=(0, 0, 0), up=(0, 1, 0),
                              fov_degrees=45.0), 16, soft_primary=0.08)
    target = np.zeros((16, 16, 3), np.float32)
    loss_of, params = _port_loss(prep, target), fit.split_scene(prep.scene)
    # the bottom-left vertex's x sweeps the left edge: pure silhouette motion
    _fd_check(loss_of, params, "verts", (0, 0), eps=2e-3, rtol=5e-2)
    # the apex's y grows and shrinks the coverage
    g = _fd_check(loss_of, params, "verts", (2, 1), eps=2e-3, rtol=5e-2)
    _vs_jax_vertex_grad(jprep, target, g)


def test_soft_primary_localized_to_silhouettes():
    """soft_primary > 0 changes the image near silhouettes only, and the
    soft image keeps to jitted JAX's by the 2-count rule."""
    cfg = scenes.serial_scene_config(24, 24)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, faithful=False,
                                                              det_dtype="float32"))
    hard = render(prepare(cfg, device="cpu")).numpy()
    soft_r = dataclasses.replace(cfg.render, soft_primary=0.02)
    soft = render(prepare(dataclasses.replace(cfg, render=soft_r), device="cpu")).numpy()
    diff = np.abs(hard - soft).max(axis=-1)
    assert (diff > 1e-6).any(), "soft_primary=0.02 changed nothing"
    assert float((diff > 1e-6).mean()) < 0.5
    jcfg = jax_scenes.serial_scene_config(24, 24)
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(
        jcfg.render, faithful=False, det_dtype="float32", soft_primary=0.02))
    want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg)))
    a, b = tonemap_u8(soft).astype(int), tonemap_u8(want).astype(int)
    assert (np.abs(a - b).max(axis=-1) > 2).mean() < 0.01


def test_tanh_is_xla_bitwise():
    """XLA's CPU f32 tanh, rebuilt from single elementwise ops: bitwise on
    200,000 seeded inputs in [0, 25] (soft_primary's arguments are never
    negative) and in [-8, 8]; torch.tanh is not.  The backward is JAX's
    (g + g*ans) * (1 - ans)."""
    rng = np.random.default_rng(0)
    for lo, hi in ((0.0, 25.0), (-8.0, 8.0)):
        x = rng.uniform(lo, hi, 200_000).astype(np.float32)
        x[:4] = [lo, 0.0004, 7.998812, 1e-6]
        want = np.asarray(jnp.tanh(jnp.asarray(x)))
        got = vm.tanh(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (torch.tanh(torch.from_numpy(x)).numpy() != want).any()
    t = torch.from_numpy(x[:1000]).requires_grad_(True)
    (g,) = torch.autograd.grad(vm.tanh(t).sum(), t)
    ans = vm.tanh(t.detach()).numpy()
    np.testing.assert_array_equal(g.numpy(), (1.0 + ans) * (1.0 - ans))


@pytest.mark.parametrize("name", ["cramer_t_safe", "cramer_bg_safe"])
def test_cramer_safe_gradients_finite_on_guarded_lanes(name):
    """The guarded Cramer solves under autograd: lanes that missed (inf
    origins), lanes whose triangle lies parallel to the ray (A == 0) and
    degenerate triangles give finite gradients (zero where guarded), and
    the valid lanes' gradients are jax.grad's."""
    from ray_tracer_tpu.ops import intersect as jax_intersect
    from ray_tracer_tpu_torch.ops import intersect

    rng = np.random.default_rng(4)
    n = 64
    orig = rng.normal(size=(n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    v = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    valid = rng.random(n) < 0.7
    orig[:8] = np.inf  # retired lanes: they never hit
    valid[:8] = False
    v[2][8:12] = v[1][8:12]  # degenerate triangles
    dirn[12:16] = v[1][12:16] - v[0][12:16]  # ray parallel to the triangle: A == 0
    valid[8:16] = True
    args = [orig, dirn, *v]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = getattr(intersect, name)(*leaves, torch.from_numpy(valid))
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(sum(o.sum() for o in out), leaves)

    def jfn(*xs):
        o = getattr(jax_intersect, name)(*xs, jnp.asarray(valid), det_dtype=jnp.float32)
        return sum(x.sum() for x in (o if isinstance(o, tuple) else (o,)))

    with jax.disable_jit():
        want = jax.grad(jfn, argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in args])
    for g, w in zip(grads, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * float(np.abs(w).max()))
    assert not np.abs(grads[0].numpy()[:8]).any()  # missed lanes take no gradient
