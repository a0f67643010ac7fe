"""Glass (transmissive materials) in the port's path tracer, against the
JAX package (mirrors tests/test_dielectric.py without its sharded test).

* `fresnel_refract` is bitwise op-by-op JAX's on random incidences, both
  sides of the interface and indices of refraction from 1 to 2.5, and
  keeps its physics: F at normal incidence is ((n-1)/(n+1))^2 (rtol
  1e-6), ior 1 reflects nothing at any angle, total internal reflection
  gives F == 1, the refracted directions obey Snell's law (1e-5).
* The segment integrator on a glass slab: ior 1 is exactly invisible; in
  a constant furnace the slab returns the furnace radiance (rtol 1e-4,
  the JAX test's); at ior 1.5 both branches are drawn; under a point
  light between the slab and a floor the floor's NEE term is the
  analytic one (rtol 1e-4, atol 1e-4).  The gradient in ior through the
  Fresnel weights is the per-lane score term's mean (rtol 1e-4), as in
  the JAX test.
* Against op-by-op JAX: bitwise where no direction is sampled (the slab
  under an up/down environment, every vertex a dielectric one, and the
  floor under a light that the glass shadows: glass is opaque to NEE
  shadow rays, as in the JAX package); on the gradcheck scene with a
  glass sphere, extra lights and bounces, more than 99% of pixels
  bitwise (the cos/sin hazard of a sampled bounce moves the rest), with
  smooth normals too (which can refract to the wrong side in both) and
  with an unvalidated ior of 0.5.
* The Whitted render and fit() refuse transmissive scenes with the JAX
  package's NotImplementedError; the GI wave is ineligible with glass.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import CameraConfig as JaxCameraConfig  # noqa: E402
from ray_tracer_tpu.config import LightConfig as JaxLightConfig  # noqa: E402
from ray_tracer_tpu.config import MaterialConfig as JaxMaterialConfig  # noqa: E402
from ray_tracer_tpu.config import SceneConfig as JaxSceneConfig  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import pathtrace as jax_pt  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import (  # noqa: E402
    CameraConfig,
    LightConfig,
    MaterialConfig,
    SceneConfig,
)
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt.fit import fit  # noqa: E402
from ray_tracer_tpu_torch.render import pathtrace as pt  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

E = 100.0  # furnace radiance (0-255 units)
A, B = 160.0, 40.0  # the up and down halves of the two-tone environment
RNG = np.random.default_rng(11)
PORT = (scenes.scene_from_numpy, MaterialConfig, LightConfig, CameraConfig, SceneConfig,
        prepare, dict(device="cpu"))
JAX = (jax_scenes.scene_from_numpy, JaxMaterialConfig, JaxLightConfig, JaxCameraConfig,
       JaxSceneConfig, jax_renderer.prepare, {})


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))


# ---------------------------------------------------------------------------
# fresnel_refract
# ---------------------------------------------------------------------------


def _lanes(cos_i, entering, ior):
    """(d, n, entering, ior) tensors: n = +z oriented against d."""
    cos_i = np.asarray(cos_i, np.float32)
    sin_i = np.sqrt(np.maximum(1.0 - cos_i ** 2, 0.0))
    d = np.stack([sin_i, np.zeros_like(cos_i), -cos_i], axis=-1).astype(np.float32)
    n = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), d.shape).copy()
    r = len(cos_i)
    return (torch.from_numpy(d), torch.from_numpy(n), torch.full((r,), bool(entering)),
            torch.full((r,), float(ior)))


def test_fresnel_refract_bitwise_vs_op_by_op_jax():
    r = 20_000
    d = RNG.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = RNG.normal(size=(r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where((d * n).sum(-1, keepdims=True) > 0, -n, n).astype(np.float32)
    entering = RNG.random(r) < 0.5
    ior = (1.0 + 1.5 * RNG.random(r)).astype(np.float32)
    ior[:3] = [1.0, 1.5, 2.4]
    got = pt.fresnel_refract(*(torch.from_numpy(x) for x in (d, n, entering, ior)))
    with jax.disable_jit():
        want = jax_pt.fresnel_refract(*(jnp.asarray(x) for x in (d, n, entering, ior)))
    for g, w in zip(got, want):
        _bitwise(g.numpy(), w)


def test_fresnel_normal_incidence_exact():
    for ior in (1.33, 1.5, 2.4):
        for entering in (True, False):
            d, n, e, i = _lanes([1.0], entering, ior)
            F, _, refr = pt.fresnel_refract(d, n, e, i)
            np.testing.assert_allclose(F.numpy(), [((ior - 1.0) / (ior + 1.0)) ** 2],
                                       rtol=1e-6)
            np.testing.assert_allclose(refr.numpy(), d.numpy(), atol=1e-6)


def test_fresnel_ior_one_is_zero_everywhere():
    cos = np.linspace(0.05, 1.0, 16)
    for entering in (True, False):
        d, n, e, i = _lanes(cos, entering, 1.0)
        F, _, refr = pt.fresnel_refract(d, n, e, i)
        np.testing.assert_allclose(F.numpy(), 0.0, atol=1e-12)
        np.testing.assert_allclose(refr.numpy(), d.numpy(), atol=1e-6)


def test_fresnel_total_internal_reflection():
    crit = np.arcsin(1.0 / 1.5)
    d, n, e, i = _lanes([np.cos(crit + 0.1), np.cos(crit - 0.1)], False, 1.5)
    F = pt.fresnel_refract(d, n, e, i)[0].numpy()
    np.testing.assert_allclose(F[0], 1.0, rtol=1e-6)
    assert F[1] < 0.999


def test_snell_direction():
    cos = np.linspace(0.3, 0.95, 8)
    for entering, ior in ((True, 1.5), (False, 1.2)):
        d, n, e, i = _lanes(cos, entering, ior)
        refr = pt.fresnel_refract(d, n, e, i)[2].numpy()
        eta = (1.0 / ior) if entering else ior
        sin_i = np.sqrt(1.0 - cos ** 2)
        ok = eta * sin_i < 1.0
        assert ok.any()
        np.testing.assert_allclose(np.linalg.norm(refr[ok], axis=-1), 1.0, rtol=1e-5)
        assert np.abs(refr[ok, 1]).max() < 1e-6
        np.testing.assert_allclose(np.abs(refr[ok, 0]), eta * sin_i[ok], atol=1e-5)
        assert (refr[ok, 2] < 0).all()


# ---------------------------------------------------------------------------
# the segment integrator on a glass slab
# ---------------------------------------------------------------------------


def _quad(y, up, half=1.0):
    v = np.array([[-half, y, -half], [-half, y, half], [half, y, -half], [half, y, half]],
                 np.float32)
    f = (np.array([[0, 1, 2], [2, 1, 3]], np.int32) if up
         else np.array([[0, 2, 1], [1, 2, 3]], np.int32))
    return v, f


def _slab_prep(pkg=PORT, ior=1.5, gi_depth=6, gi_samples=4, intensity=0.0, floor=None,
               light=(0.0, 5.0, 0.0), env=None, **render_kw):
    """The floating glass slab (top y=0 outward +y, bottom y=-0.5 outward
    -y) in the port (pkg=PORT) or the JAX package, with optionally a
    Lambertian floor of albedo 0.5 at y=-2 and a lat-long environment."""
    sfn, Mat, Light, Cam, Scn, prep, extra = pkg
    parts = [_quad(0.0, True), _quad(-0.5, False)]
    mats = [Mat(base_color=(255.0, 255.0, 255.0), transmissive=True, ior=ior)]
    fmat = [0, 0, 0, 0]
    if floor:
        parts.append(_quad(-2.0, True, half=4.0))
        mats.append(Mat(base_color=(127.5, 127.5, 127.5)))
        fmat += [1, 1]
    verts = np.concatenate([v for v, _ in parts])
    faces = np.concatenate([f + 4 * k for k, (_, f) in enumerate(parts)])
    lc = Light(position=light, intensity=intensity)
    scene = sfn(verts, faces, np.asarray(fmat, np.int32), tuple(mats), lc, **extra)
    if env is not None:
        img = torch.from_numpy(env) if pkg is PORT else jnp.asarray(env)
        scene = scene._replace(env_image=img)
    cfg = Scn(materials=tuple(mats), light=lc,
              camera=Cam(position=(0.0, 2.0, 0.0), target=(0.05, 0.0, 0.05), width=8,
                         height=8))
    cfg = _replace(cfg, faithful=False, traversal="packed", scheduler="persistent",
                   gi_samples=gi_samples, gi_depth=gi_depth, **render_kw)
    return prep(cfg, scene=scene)


def _two_tone():
    env = np.empty((4, 8, 3), np.float32)
    env[:2] = A
    env[2:] = B
    return env


def _straight_down_rays(prep, n=6):
    xs = np.linspace(-0.8, 0.77, n, dtype=np.float32) + 0.013
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    orig = np.stack([gx, np.full_like(gx, 2.0), gz], axis=-1).reshape(-1, 3)
    dirn = np.broadcast_to(np.array([0.0, -1.0, 0.0], np.float32), orig.shape).copy()
    return RayBatch.make(torch.from_numpy(orig), torch.from_numpy(dirn),
                         mint=prep.cfg.render.shadow_eps)


def _trace(prep, rays, scene=None):
    with torch.no_grad():
        return pt.pathtrace_rays(rays, prep.scene if scene is None else scene,
                                 prep.packed.arrays, prep.packed.meta, prep.cfg).numpy()


def test_ior_one_slab_exactly_invisible():
    prep = _slab_prep(ior=1.0, gi_depth=3, gi_samples=2)
    rad = _trace(prep, _straight_down_rays(prep))
    want = np.broadcast_to(np.asarray(prep.cfg.render.background, np.float32), rad.shape)
    np.testing.assert_array_equal(rad, want)


def test_furnace_with_glass_slab():
    flat = np.full((4, 8, 3), E, np.float32)
    img = render(_slab_prep(gi_depth=8, gi_samples=4, env=flat)).numpy()
    np.testing.assert_allclose(img, E, rtol=1e-4)


def test_ior_gradient_matches_analytic():
    """d radiance / d ior through the Fresnel weights on one glass sheet at
    normal incidence: each reflected lane contributes A F'/F, each
    refracted one -B F'/(1-F) (the JAX test's closed form)."""
    vt, ft = _quad(0.0, True)
    mats = (MaterialConfig(transmissive=True, ior=1.5),)
    light = LightConfig(position=(0.0, 5.0, 0.0), intensity=0.0)
    scene = scenes.scene_from_numpy(vt, ft, np.zeros((2,), np.int32), mats, light,
                                    device="cpu")._replace(env_image=torch.from_numpy(_two_tone()))
    cfg = _replace(SceneConfig(materials=mats, light=light,
                               camera=CameraConfig(position=(0.0, 2.0, 0.0),
                                                   target=(0.05, 0.0, 0.05), width=8, height=8)),
                   faithful=False, traversal="packed", scheduler="persistent", gi_samples=1,
                   gi_depth=1)
    prep = prepare(cfg, scene=scene)
    rays = _straight_down_rays(prep)
    rad = _trace(prep, rays)
    reflected = rad[:, 0] > 0.5 * (A + B)
    assert reflected.any() and (~reflected).any()
    ior = torch.tensor(1.5, requires_grad=True)
    sc = prep.scene._replace(ior=ior * torch.ones_like(prep.scene.ior))
    out = pt.pathtrace_rays(rays, sc, prep.packed.arrays, prep.packed.meta, prep.cfg)
    (g,) = torch.autograd.grad(out.mean(), [ior])
    F = ((1.5 - 1.0) / 2.5) ** 2
    Fp = 2.0 * (0.5 / 2.5) * (2.0 / 2.5 ** 2)
    want = np.where(reflected, A * Fp / F, -B * Fp / (1.0 - F)).mean()
    np.testing.assert_allclose(float(g), want, rtol=1e-4)


def test_ior_one_and_half_mixes_both_branches():
    prep = _slab_prep(ior=1.5, gi_depth=6, gi_samples=16)
    rad = _trace(prep, _straight_down_rays(prep),
                 prep.scene._replace(env_image=torch.from_numpy(_two_tone())))
    mean = rad.mean()
    assert B < mean < A
    assert mean < B + 0.25 * (A - B)
    assert (np.abs(rad - B) > 1e-3).any()


def test_point_light_shines_through_ior_one_slab():
    prep = _slab_prep(ior=1.0, gi_depth=3, gi_samples=2, intensity=200.0, floor=True,
                      light=(0.0, -1.0, 0.0), background=(0.0, 0.0, 0.0))
    rad = _trace(prep, _straight_down_rays(prep))
    xs = np.linspace(-0.8, 0.77, 6, dtype=np.float32) + 0.013
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    px = np.stack([gx, np.full_like(gx, -2.0), gz], -1).reshape(-1, 3)
    to_l = np.array([0.0, -1.0, 0.0]) - px
    r2 = (to_l ** 2).sum(-1)
    cos = np.maximum(to_l[:, 1] / np.sqrt(r2), 0.0)
    want = (0.5 / np.pi * 200.0 * cos / r2)[:, None] * np.ones(3)
    np.testing.assert_allclose(rad, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# against op-by-op JAX
# ---------------------------------------------------------------------------


def _jax_eager(jprep):
    with jax.disable_jit():
        return np.asarray(jax_renderer.render(jprep), np.float32)


@pytest.mark.parametrize("case", ["two_tone_env", "glass_shadows_the_floor"])
def test_slab_bitwise_vs_op_by_op_jax(case):
    """No sampled direction: every vertex of the two-tone slab is glass;
    through the ior-1 slab (two straight refractions) the floor's last
    vertex takes NEE alone, toward a light above the glass, which blocks
    it (opaque to shadow rays)."""
    if case == "two_tone_env":
        kw = dict(ior=1.5, gi_depth=6, gi_samples=3, env=_two_tone(), gi_sample_batch=3)
    else:
        # parallel shading: shadow rays toward the light (the serial
        # variant's quirk points them away)
        kw = dict(ior=1.0, gi_depth=2, gi_samples=2, intensity=200.0, floor=True,
                  light=(0.0, 3.0, 0.0), background=(0.0, 0.0, 0.0), shading="parallel")
    got = render(_slab_prep(PORT, **kw)).numpy()
    _bitwise(got, _jax_eager(_slab_prep(JAX, **kw)))
    if case == "glass_shadows_the_floor":
        # the floor seen through the slab gets no light: most pixels
        assert (got == 0.0).all(axis=-1).mean() > 0.5


def _gradcheck_glass_pair(size, S, D, ior=1.5, **kw):
    """The gradcheck scene with its sphere material made glass, a brighter
    light and two extra lights, in both packages."""
    extra = ((-4.0, 6.0, -2.0, 300.0), (0.0, 5.0, 5.0, 200.0))
    out = []
    for pkg in (PORT, JAX):
        port = pkg is PORT
        scene, cfg = (scenes.gradcheck_scene(size, size, device="cpu") if port
                      else jax_scenes.gradcheck_scene(size, size))
        t = torch if port else jnp
        m = scene.materials.base_color.shape[0]
        trans = np.zeros((m,), bool)
        trans[-1] = True
        scene = scene._replace(
            light_intensity=t.asarray(400.0, dtype=t.float32),
            transmissive=t.asarray(trans), ior=t.asarray(np.full((m,), ior, np.float32)))
        cfg = dataclasses.replace(
            _replace(cfg, faithful=False, det_dtype="float32", gi_samples=S, gi_depth=D,
                     gi_wave="off", background=(40.0, 30.0, 20.0), **kw),
            extra_lights=tuple(pkg[2](position=e[:3], intensity=e[3]) for e in extra))
        out.append(pkg[5](cfg, scene=scene))
    return out


@pytest.mark.parametrize("case", ["persistent", "csr_smooth", "tiled_ior_half"])
def test_gradcheck_glass_vs_op_by_op_jax(case):
    kw = {"persistent": dict(traversal="packed", scheduler="persistent", gi_specular=True),
          "csr_smooth": dict(traversal="csr", normal_mode="smooth"),
          "tiled_ior_half": dict(traversal="packed", scheduler="tiled", ior=0.5)}[case]
    prep, jprep = _gradcheck_glass_pair(16, 2, 2, **kw)
    assert prep.scene.transmissive is not None and not prep.setup.gi_wave
    got = render(prep).numpy()
    want = _jax_eager(jprep)
    same = (got.view(np.uint32) == want.view(np.uint32)).all(axis=-1)
    assert same.mean() > 0.99, same.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=0.005)
    assert np.isfinite(got).all() and got.max() > 1.0


def test_whitted_paths_reject_transmissive():
    prep = _slab_prep(gi_samples=0)
    with pytest.raises(NotImplementedError, match="path-traced"):
        render(prep)
    with pytest.raises(NotImplementedError, match="refraction"):
        fit(prep, torch.zeros((8, 8, 3)), steps=1)


def test_gi_wave_ineligible_for_glass():
    prep = _slab_prep(gi_samples=2, gi_depth=2, gi_wave="auto")
    assert not prep.setup.gi_wave
    assert not pt.gi_wave_eligible(prep.cfg, prep.scene)
    assert not pt.gi_wave_eligible(prep.cfg)  # from cfg's materials alone
    with pytest.raises(ValueError, match="ineligible"):
        _slab_prep(gi_samples=2, gi_depth=2, gi_wave="on")
