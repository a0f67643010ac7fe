"""The appearance features in the port's path tracer: the GI wave's plain
version (kernel F's, on the CPU) and the segment integrator, with
environment maps, smooth normals and textures, against the JAX package
run op by op (`jax.disable_jit()`).

* Bitwise, for both integrators, where radiance does not depend on the
  sampled directions (tests/test_pathtrace.py's cases): the env furnace
  (a plane under a constant map, :695), smooth normals on the plane (:744;
  the image also equals face mode's to 1e-5), the textured quad at depth
  0 (checker and image, :898) and every feature with the mirror mix at
  depth 0 (:973).  The port's two integrators agree bitwise there too.
* Statistically otherwise, with the JAX package's thresholds: a
  non-constant map on the gradcheck scene (more than 90% of pixels within
  1e-3, the means within 2%, :715), smooth normals on it (95% within 1e-4,
  :744), the checker quad with a bounce (95% within 1e-4, :922): the
  port's wave against op-by-op JAX's wave, and against the port's
  segment integrator.
* `build_gi_wave_tables`' texture and smooth-normal tables are bitwise
  JAX's; the GI wave takes environment maps unless gi_env_nee is set.
"""

import dataclasses
import types

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
from ray_tracer_tpu.io.obj import MeshArrays as JaxMeshArrays  # noqa: E402
from ray_tracer_tpu.models import meshes as jax_meshes  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import pathtrace as jax_pt  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import (  # noqa: E402
    CameraConfig,
    LightConfig,
    MaterialConfig,
    SceneConfig,
)
from ray_tracer_tpu_torch.io.obj import MeshArrays  # noqa: E402
from ray_tracer_tpu_torch.models import meshes, scenes  # noqa: E402
from ray_tracer_tpu_torch.render import pathtrace as pt  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

SIZE = 16
E = 100.0  # the furnace's constant environment
RHO = 0.5  # the furnace plane's albedo
JAX = dict(mg=jax_meshes, Mat=JaxMaterialConfig, Light=JaxLightConfig, Cam=JaxCameraConfig,
           Scn=JaxSceneConfig, MA=JaxMeshArrays, sfm=jax_scenes.scene_from_meshes,
           prep=jax_renderer.prepare, arr=lambda a: jnp.asarray(a, jnp.float32), extra={})
PORT = dict(mg=meshes, Mat=MaterialConfig, Light=LightConfig, Cam=CameraConfig,
            Scn=SceneConfig, MA=MeshArrays, sfm=scenes.scene_from_meshes, prep=prepare,
            arr=lambda a: torch.tensor(np.asarray(a, np.float32)), extra=dict(device="cpu"))
INTEGRATORS = ["wave", "segments"]


def _bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _pair(build):
    """(JAX Prepared, port Prepared) from build(namespace of one package's
    classes) -> (scene, cfg)."""
    out = []
    for k in (JAX, PORT):
        ns = types.SimpleNamespace(**k)
        scene, cfg = build(ns)
        out.append(ns.prep(cfg, scene=scene))
    return out


def _gi(cfg, S, D, **kw):
    kw.setdefault("gi_wave", "on")
    return _replace(cfg, faithful=False, det_dtype="float32", traversal="packed",
                    scheduler="persistent", wave=128, pump=2, ray_tile=64, gi_samples=S,
                    gi_depth=D, **kw)


def _plane(k, base_color=(140.0, 90.0, 200.0), intensity=60.0, env=None, **mat_kw):
    mats = (k.Mat(base_color=base_color, **mat_kw),)
    light = k.Light(position=(0.5, 6.0, 0.3), intensity=intensity)
    scene = k.sfm([(k.mg.make_plane(extent=8.0, y=-1.0, density=2), 0)], mats, light,
                  **k.extra)
    if env is not None:
        scene = scene._replace(env_image=k.arr(env))
    cfg = k.Scn(materials=mats, light=light, camera=k.Cam(
        position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=SIZE, height=SIZE))
    return scene, cfg


def _quad(k, texture, tex=None, env=None, km=None):
    quad = k.MA(verts=np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
                faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                uv_faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    mirror = {} if km is None else dict(km=km, reflective=True)
    mat = k.Mat(base_color=(200.0, 120.0, 60.0), kd=2.0, ks=0.0, spec_alpha=4.0, ka=0.3,
                **mirror)
    light = k.Light(position=(0.0, 8.0, 0.0), intensity=50.0)
    scene = k.sfm([(quad, 0)], [mat], light, **k.extra)
    if tex is not None:
        scene = scene._replace(texture_image=k.arr(tex))
    if env is not None:
        scene = scene._replace(env_image=k.arr(env))
    cfg = k.Scn(materials=(mat,), light=light, camera=k.Cam(
        position=(0.0, 5.0, 0.01), target=(0, 0, 0), up=(0, 0, 1), fov_degrees=45.0,
        width=SIZE, height=SIZE))
    return scene, _replace(cfg, shading="parallel", shadow_eps=1e-3, fused_shadow=False,
                           texture=texture, texture_scale=4.0)


def _gradcheck(k, size=SIZE, env=None):
    scene, cfg = (jax_scenes.gradcheck_scene(size, size) if k.prep is jax_renderer.prepare
                  else scenes.gradcheck_scene(size, size, device="cpu"))
    scene = scene._replace(light_intensity=k.arr(40.0))
    if env is not None:
        scene = scene._replace(env_image=k.arr(env))
    return scene, cfg


def _flat(c, shape=(4, 8)):
    return np.broadcast_to(np.asarray(c, np.float32), shape + (3,)).copy()


TEX = np.linspace(0.1, 1.0, 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)
RAMP = np.linspace(5.0, 90.0, 4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)


def _port(prep, integrator):
    cfg = _replace(prep.cfg, gi_wave="on" if integrator == "wave" else "off")
    p = prep._replace(cfg=cfg)
    assert p.frame().gi_wave == (integrator == "wave")
    return render(p).numpy()


def _jax(jprep, integrator):
    with jax.disable_jit():
        if integrator == "wave":
            assert jax_pt.gi_wave_eligible(jprep)
            return np.asarray(jax_pt._render_pt_wave(jprep), np.float32)
        off = jprep._replace(cfg=_replace(jprep.cfg, gi_wave="off"))
        return np.asarray(jax_renderer.render(off), np.float32)


def _both(jprep, prep, integrator):
    img = _port(prep, integrator)
    _bitwise(img, _jax(jprep, integrator))
    return img


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_env_furnace_bitwise(integrator):
    jprep, prep = _pair(lambda k: (lambda sc: (sc[0], _gi(sc[1], 3, 1)))(
        _plane(k, base_color=(255.0 * RHO,) * 3, intensity=0.0, env=_flat(E))))
    img = _both(jprep, prep, integrator)
    hit = np.abs(img - E).sum(-1) > 1e-3
    assert hit.any()
    np.testing.assert_allclose(img[hit], RHO * E, atol=1e-3)
    _bitwise(img, _port(prep, "segments" if integrator == "wave" else "wave"))


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_smooth_plane_bitwise(integrator):
    jprep, prep = _pair(lambda k: (lambda sc: (sc[0], _gi(sc[1], 2, 1, normal_mode="smooth",
                                                          background=(30.0, 20.0, 10.0))))(
        _plane(k)))
    assert prep.gi.fvn9 is not None and prep.setup.vn is not None
    img = _both(jprep, prep, integrator)
    face = _port(prep._replace(cfg=_replace(prep.cfg, normal_mode="face")), integrator)
    np.testing.assert_allclose(img, face, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("texture", ["checker", "image"])
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_texture_depth0_bitwise(texture, integrator):
    tex = TEX if texture == "image" else None
    jprep, prep = _pair(lambda k: (lambda sc: (sc[0], _gi(sc[1], 2, 0)))(
        _quad(k, texture, tex=tex)))
    assert prep.gi.fuv7 is not None and (prep.gi.tex_image is not None) == (tex is not None)
    img = _both(jprep, prep, integrator)
    _bitwise(img, _port(prep, "segments" if integrator == "wave" else "wave"))
    untextured = _port(prep._replace(cfg=_replace(prep.cfg, texture="none")), integrator)
    assert (np.abs(img - untextured) > 1e-3).any()


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_all_features_depth0_bitwise(integrator):
    """Smooth normals, the checker, a constant map and the mirror mix at
    once, at depth 0 (each feature a table of its own that must compose)."""
    jprep, prep = _pair(lambda k: (lambda sc: (sc[0], _gi(sc[1], 2, 0, normal_mode="smooth")))(
        _quad(k, "checker", env=_flat([40.0, 30.0, 20.0]), km=0.3)))
    assert prep.setup.gi_spec and prep.gi.fvn9 is not None and prep.gi.fuv7 is not None
    img = _both(jprep, prep, integrator)
    _bitwise(img, _port(prep, "segments" if integrator == "wave" else "wave"))


STATISTICAL = {
    # (scene and config, S, D, extra render knobs, share, tolerance)
    "env_ramp_gradcheck": (lambda k: _gradcheck(k, env=RAMP), 2, 2, {}, 0.9, 1e-3),
    "smooth_gradcheck": (lambda k: _gradcheck(k), 2, 1, dict(normal_mode="smooth"), 0.95,
                         1e-4),
    "checker_bounce": (lambda k: _quad(k, "checker"), 2, 1,
                       dict(background=(12.0, 8.0, 4.0)), 0.95, 1e-4),
}


@pytest.mark.parametrize("case", list(STATISTICAL))
def test_direction_dependent_cases_statistical(case):
    build, S, D, kw, share, tol = STATISTICAL[case]
    jprep, prep = _pair(lambda k: (lambda sc: (sc[0], _gi(sc[1], S, D, **kw)))(build(k)))
    wave = _port(prep, "wave")
    for other in (_jax(jprep, "wave"), _port(prep, "segments")):
        same = (np.abs(wave - other) <= tol).all(axis=-1)
        assert same.mean() > share, same.mean()
        np.testing.assert_allclose(wave.mean(), other.mean(), rtol=0.02)


def test_gi_tables_with_features_equal_jax():
    jprep, prep = _pair(lambda k: (lambda sc: (sc[0], _gi(sc[1], 2, 1, normal_mode="smooth")))(
        _quad(k, "image", tex=TEX)))
    rc, jrc = prep.cfg.render, jprep.cfg.render
    tab = pt.build_gi_wave_tables(prep.scene, rc, False)
    with jax.disable_jit():
        want = jax_pt.build_gi_wave_tables(jprep.scene, jrc, False)
    assert tab.km is None and want[1] is None
    assert len(want) == 6
    for got, w in zip(tab[:6], want):
        if w is not None:
            _bitwise(got.numpy(), w)
    for name in ("tri9", "albedo", "fuv7", "tex_image", "bc255", "fvn9"):
        _bitwise(getattr(prep.gi, name).numpy(), getattr(tab, name).numpy())
    # a scene without uv data has no texture tables (texture silently off)
    no_uv = prep.scene._replace(uvs=None, uv_faces=None)
    assert pt.build_gi_wave_tables(no_uv, rc, False).fuv7 is None


def test_gi_wave_takes_env_maps_but_not_env_nee():
    jprep, prep = _pair(lambda k: (lambda sc: (sc[0], _gi(sc[1], 2, 1, gi_wave="auto")))(
        _plane(k, env=RAMP)))
    assert pt.gi_wave_eligible(prep.cfg, prep.scene)
    assert jax_pt.gi_wave_eligible(jprep)
    nee = _replace(prep.cfg, gi_env_nee=True)
    jnee = jprep._replace(cfg=_replace(jprep.cfg, gi_env_nee=True))
    assert not pt.gi_wave_eligible(nee, prep.scene) and not jax_pt.gi_wave_eligible(jnee)
    with pytest.raises(ValueError, match="ineligible"):
        pt.gi_wave_eligible(_replace(nee, gi_wave="on"), prep.scene)
    with pytest.raises(NotImplementedError, match="gi_env_nee"):
        prepare(nee, scene=prep.scene)
