"""Environment next-event estimation with MIS (gi_env_nee) in the port's
path tracer, against the JAX package (mirrors tests/test_pathtrace.py's
env-NEE tests).

The sampler's tables come from a cumsum and a sum that XLA and PyTorch
order differently, and its lookups from `acos` and `atan2`, whose CPU
bits differ between jnp and torch (ROADMAP.md, parity hazards), so env
NEE is held to the JAX package statistically:

* `EnvSampler`'s tables against the JAX package's expressions
  (render/pathtrace.py:282-300) to rtol 1e-6; its pdf integrates to 1
  over the sphere (rtol 1e-5) and each sampled direction lies in the
  texel it drew, at the pdf `pdf()` gives it (rtol 1e-6).
* The gradcheck scene under a sky with a bright sun patch, S 4, D 1, on
  the persistent march and the CSR grid (and with an extra light and a
  glass sphere): against op-by-op JAX, every pixel within 1e-3 of the
  image's largest value, more than half of them bitwise (63% measured)
  and the means within 0.1%.
* The JAX package's furnace: with a constant environment the estimator
  stays unbiased, its mean within 2% of rho E and each pixel within 20%
  (the JAX test's rule), and within 1% of the JAX package's own mean; on
  a single bright texel, 8 samples with env NEE are closer to the
  96-sample reference than 8 without.
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
from ray_tracer_tpu.models import meshes as jax_meshes  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import (  # noqa: E402
    CameraConfig,
    LightConfig,
    MaterialConfig,
    SceneConfig,
)
from ray_tracer_tpu_torch.models import meshes, scenes  # noqa: E402
from ray_tracer_tpu_torch.render import pathtrace as pt  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

E = 100.0  # the furnace's environment radiance
RHO = 0.5  # the furnace plane's albedo


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _sky(he=16, we=32, seed=3):
    """A lat-long sky: a gradient with an azimuthal swing, noise, and a
    bright sun patch."""
    rng = np.random.default_rng(seed)
    pol, azi = np.meshgrid(np.linspace(0, 1, he), np.linspace(0, 1, we), indexing="ij")
    sky = np.stack([40 + 80 * (1 - pol), 50 + 60 * (1 - pol),
                    70 + 30 * np.cos(2 * np.pi * azi)], -1)
    sky[he // 5:he // 5 + 2, we // 3:we // 3 + 3] = 3000.0
    return (sky + 10 * rng.random(sky.shape)).astype(np.float32)


def _jax_tables(env):
    """The JAX package's env-NEE tables, its expressions as written
    (render/pathtrace.py:290-300), eager."""
    he, we = env.shape[0], env.shape[1]
    with jax.disable_jit():
        edges = jnp.cos(jnp.arange(he + 1, dtype=jnp.float32) / he * jnp.pi)
        dcos = edges[:-1] - edges[1:]
        th_c = (jnp.arange(he, dtype=jnp.float32) + 0.5) / he * jnp.pi
        lum = jnp.mean(jnp.asarray(env), axis=-1)
        wtex = ((lum + jnp.float32(1e-3)) * jnp.sin(th_c)[:, None]).reshape(-1)
        wsum = wtex.sum()
        return dict(edges=edges, dcos=dcos, wtex=wtex, wsum=wsum,
                    cdf=jnp.cumsum(wtex) / wsum, texel_sr=(2.0 * jnp.pi / we) * dcos)


def test_env_sampler_tables_vs_jax():
    for env in (_sky(), _sky(64, 128, seed=5), np.full((4, 8, 3), E, np.float32)):
        s = pt.EnvSampler.build(torch.from_numpy(env))
        want = _jax_tables(env)
        for name, w in want.items():
            np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        assert s.width == env.shape[1]


def test_env_sampler_pdf_and_samples():
    env = _sky()
    s = pt.EnvSampler.build(torch.from_numpy(env))
    he, we = env.shape[0], env.shape[1]
    # the pdf over the texels' solid angles sums to 1
    iv = torch.arange(he).repeat_interleave(we)
    total = (s.wtex / s.wsum).double().sum()
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)
    per_sr = s._texel_pdf(torch.arange(he * we), iv)
    np.testing.assert_allclose(float((per_sr * s.texel_sr[iv]).double().sum()), 1.0, rtol=1e-5)
    rng = np.random.default_rng(1)
    u = [torch.from_numpy(rng.random(50_000).astype(np.float32)) for _ in range(3)]
    d, pdf = s.sample(*u)
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0, rtol=1e-5)
    # the sampled texel and the pdf at the direction agree away from
    # texel edges (a jitter of exactly 0 or 1 lies on one)
    inner = ((u[1] > 1e-3) & (u[1] < 1 - 1e-3) & (u[2] > 1e-3) & (u[2] < 1 - 1e-3)).numpy()
    np.testing.assert_allclose(s.pdf(d).numpy()[inner], pdf.numpy()[inner], rtol=1e-6)
    # the bright patch is drawn far more often than its area's share
    idx = torch.clamp(torch.searchsorted(s.cdf, u[0]), 0, he * we - 1)
    sun = torch.from_numpy((env.mean(-1) > 1000.0).reshape(-1))
    assert float(sun[idx].float().mean()) > 10 * float(sun.float().mean())


def _gradcheck_pair(trav, glass=False, extra=()):
    out = []
    sky = _sky()
    for port in (True, False):
        scene, cfg = (scenes.gradcheck_scene(16, 16, device="cpu") if port
                      else jax_scenes.gradcheck_scene(16, 16))
        t = torch if port else jnp
        scene = scene._replace(env_image=t.asarray(sky), light_intensity=t.asarray(40.0))
        if glass:
            m = scene.materials.base_color.shape[0]
            trans = np.zeros((m,), bool)
            trans[-1] = True
            scene = scene._replace(transmissive=t.asarray(trans),
                                   ior=t.asarray(np.full((m,), 1.5, np.float32)))
        light = LightConfig if port else JaxLightConfig
        cfg = dataclasses.replace(
            _replace(cfg, faithful=False, det_dtype="float32", gi_samples=4, gi_depth=1,
                     gi_wave="off", gi_env_nee=True, **trav),
            extra_lights=tuple(light(position=e[:3], intensity=e[3]) for e in extra))
        out.append((prepare if port else jax_renderer.prepare)(cfg, scene=scene))
    return out


ENV_CASES = {
    "persistent": (dict(traversal="packed", scheduler="persistent"), False, ()),
    "csr": (dict(traversal="csr"), False, ()),
    "persistent_glass_extra_light": (dict(traversal="packed", scheduler="persistent"), True,
                                     ((-4.0, 6.0, -2.0, 60.0),)),
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_env_nee_vs_op_by_op_jax(case):
    trav, glass, extra = ENV_CASES[case]
    prep, jprep = _gradcheck_pair(trav, glass, extra)
    assert not prep.setup.gi_wave
    got = render(prep).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_renderer.render(jprep), np.float32)
    assert np.isfinite(got).all() and got.max() > 10.0
    close = (np.abs(got - want) <= 1e-3 * np.abs(want).max()).all(axis=-1)
    assert close.all(), close.mean()
    same = (got.view(np.uint32) == want.view(np.uint32)).all(axis=-1)
    assert same.mean() > 0.5, same.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)


def _furnace(port=True, env=None, **render_kw):
    """A lone ground plane under a constant environment (or `env`)."""
    mg, Mat, Light, Cam, Scn, sfm = (
        (meshes, MaterialConfig, LightConfig, CameraConfig, SceneConfig,
         scenes.scene_from_meshes) if port else
        (jax_meshes, JaxMaterialConfig, JaxLightConfig, JaxCameraConfig, JaxSceneConfig,
         jax_scenes.scene_from_meshes))
    mats = (Mat(base_color=(255.0 * RHO,) * 3),)
    light = Light(position=(0.0, 5.0, 0.0), intensity=0.0)
    scene = sfm([(mg.make_plane(extent=8.0, y=-1.0, density=2), 0)], mats, light,
                **({"device": "cpu"} if port else {}))
    img = np.full((4, 8, 3), E, np.float32) if env is None else env
    scene = scene._replace(env_image=torch.from_numpy(img) if port else jnp.asarray(img))
    cfg = Scn(materials=mats, light=light,
              camera=Cam(position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=16,
                         height=16))
    cfg = _replace(cfg, faithful=False, traversal="packed", scheduler="persistent", wave=128,
                   ray_tile=64, gi_depth=1, **render_kw)
    return (prepare if port else jax_renderer.prepare)(cfg, scene=scene)


def test_env_nee_unbiased_on_furnace():
    img = render(_furnace(gi_samples=64, gi_env_nee=True, gi_sample_batch=16)).numpy()
    np.testing.assert_allclose(img.mean(), RHO * E, rtol=0.02)
    np.testing.assert_allclose(img, RHO * E, rtol=0.2)
    want = np.asarray(jax_renderer.render(_furnace(False, gi_samples=64, gi_env_nee=True,
                                                   gi_sample_batch=16)))
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=0.01)
    # without env NEE the furnace is exact (every bounce escapes with
    # weight rho)
    exact = render(_furnace(gi_samples=2)).numpy()
    np.testing.assert_allclose(exact, RHO * E, rtol=1e-5)


def test_env_nee_cuts_variance_on_concentrated_env():
    env = np.zeros((8, 16, 3), np.float32)
    env[2, 5] = 20000.0

    def img(**kw):
        return render(_furnace(env=env, gi_sample_batch=16, **kw)).numpy()

    ref = img(gi_samples=96, gi_env_nee=True)
    nee, plain = img(gi_samples=8, gi_env_nee=True), img(gi_samples=8)
    assert np.isfinite(nee).all() and np.isfinite(plain).all()
    assert np.abs(nee - ref).mean() < np.abs(plain - ref).mean()
