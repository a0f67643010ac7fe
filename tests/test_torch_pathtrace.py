"""The port's path tracer (render/pathtrace.py): the sampler, the segment
integrator, the GI wave's eligibility and the refused features, against
the JAX package.

* `_hash_u01` and `ray_sample_keys` are bitwise JAX's on random uint32
  keys and salts, and on rays whose bits include +-0, +-inf and NaN.
* `_onb` is bitwise JAX's.  `_cosine_sample` takes cos and sin in float64
  rounded to float32 (no float32 formula gives jnp's bits; ROADMAP.md's
  parity hazards): its angles' cos and sin are numpy's float64 values
  rounded, and its directions agree with JAX's to 2e-7 absolute, with the
  angles where jnp's cos or sin differs from the rounded value under 3%.
* The segment integrator is bitwise op-by-op JAX's on the escape-only
  plane (radiance there does not depend on the sampled directions) and at
  gi_depth 0 on the gradcheck scene (no bounce), for the fused NEE on the
  persistent march, the separate shadow traversal of the tiled march and
  the CSR DDA.  With bounces on the gradcheck scene more than 99% of its
  pixels are bitwise op-by-op JAX's (the cos/sin hazard moves the rest),
  and against jitted JAX, which contracts the Cramer arithmetic and so
  flips some bounces, it keeps the JAX package's statistical rule with a
  lower share (tests/test_pathtrace.py: pixels within 1e-5, the means
  within 2%).
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
from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import meshes as jax_meshes  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import pathtrace as jax_pt  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import (  # noqa: E402
    CameraConfig,
    LightConfig,
    MaterialConfig,
    SceneConfig,
    apply_turbo,
)
from ray_tracer_tpu_torch.models import meshes, scenes  # noqa: E402
from ray_tracer_tpu_torch.render import pathtrace as pt  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

RNG = np.random.default_rng(7)
PLANE_BG = (30.0, 20.0, 10.0)
# the gradcheck scene's light (intensity 1 in 0-255 units) is too dim for
# GI to register; both packages get the same brighter one
GI_LIGHT = 40.0
SEGMENT_TRAVERSALS = {
    "persistent_fused": dict(traversal="packed", scheduler="persistent", gi_fuse_nee=True),
    "tiled_shadow": dict(traversal="packed", scheduler="tiled"),
    "csr": dict(traversal="csr"),
}


def _bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _u32(n):
    return RNG.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def test_hash_u01_bitwise_vs_jax():
    x = _u32(50_000)
    keys = torch.from_numpy(x.astype(np.int64))
    for salt in (0, 13, 0x85EBCA77 * 3 + 13, 0x5BD1E995 * 2 + 7, (1 << 32) - 1, 1 << 40):
        _bitwise(pt._hash_u01(keys, salt), jax_pt._hash_u01(jnp.asarray(x), salt))
    salts = _u32(50_000)
    _bitwise(pt._hash_u01(keys, torch.from_numpy(salts.astype(np.int64))),
             jax_pt._hash_u01(jnp.asarray(x), jnp.asarray(salts)))
    depth = RNG.integers(0, 8, size=50_000).astype(np.int32)
    want_salt = jnp.uint32(0x85EBCA77) * (jnp.asarray(depth) + 1).astype(jnp.uint32) + 13
    got_salt = (pt._mul32(torch.from_numpy(depth.astype(np.int64)) + 1, 0x85EBCA77)
                + 13) & pt._M32
    np.testing.assert_array_equal(got_salt.numpy().astype(np.uint32), np.asarray(want_salt))


def test_ray_sample_keys_bitwise_vs_jax():
    bits = _u32(6 * 4096).reshape(-1, 6)
    specials = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00001, 0x00000001, 0x3F800000], np.uint32)
    bits[: specials.size] = np.repeat(specials, 6).reshape(-1, 6)
    bits[100:200, 3] = specials[RNG.integers(0, specials.size, 100)]
    f = bits.view(np.float32)
    got = pt.ray_sample_keys(torch.from_numpy(f[:, :3].copy()),
                             torch.from_numpy(f[:, 3:].copy()))
    want = jax_pt.ray_sample_keys(jnp.asarray(f[:, :3]), jnp.asarray(f[:, 3:]))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    # and the per-sample stride: key + 0x632BE59B * (s + 1), wrapped
    k = jnp.asarray(want)
    for s in (0, 1, 7):
        np.testing.assert_array_equal(
            pt.sample_key(got, s).numpy().astype(np.uint32),
            np.asarray(k + jnp.uint32(0x632BE59B) * jnp.uint32(s + 1)))


def _unit_normals(n):
    v = RNG.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]]  # the branch's edges
    return v.astype(np.float32)


def test_onb_bitwise_vs_jax():
    n = _unit_normals(20_000)
    with jax.disable_jit():
        wb1, wb2 = jax_pt._onb(jnp.asarray(n))
    b1, b2 = pt._onb(torch.from_numpy(n))
    _bitwise(b1.numpy(), wb1)
    _bitwise(b2.numpy(), wb2)


def test_cosine_sample_vs_jax():
    """cos and sin of the sampled angle: float64 rounded to float32 here;
    jnp's float32 functions differ from that in the last bit for about
    1.3% of angles, so the directions agree to 2e-7 and the rest of the
    arithmetic is JAX's (bitwise where both cos and sin agree)."""
    n = _unit_normals(200_000)
    u1 = RNG.random(200_000).astype(np.float32)
    u2 = RNG.random(200_000).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax_pt._cosine_sample(jnp.asarray(n), jnp.asarray(u1),
                                                jnp.asarray(u2)))
    got = pt._cosine_sample(torch.from_numpy(n), torch.from_numpy(u1),
                            torch.from_numpy(u2)).numpy()
    phi = (np.float32(2.0 * np.pi) * u2).astype(np.float32)
    c, s = pt.cos_sin(torch.from_numpy(phi))
    _bitwise(c.numpy(), np.cos(phi.astype(np.float64)).astype(np.float32))
    _bitwise(s.numpy(), np.sin(phi.astype(np.float64)).astype(np.float32))
    jc, js = np.asarray(jnp.cos(jnp.asarray(phi))), np.asarray(jnp.sin(jnp.asarray(phi)))
    trig_differs = (jc != c.numpy()) | (js != s.numpy())
    assert 0.005 < trig_differs.mean() < 0.03
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    _bitwise(got[~trig_differs], want[~trig_differs])


def test_sin_cos_parity_counts():
    """The measurement behind the float64 route (ROADMAP.md, parity
    hazards): on 200,000 f32 angles f32(2 pi) * u, u from
    np.random.default_rng(0), jnp's cos and sin differ from the float64
    value rounded to f32 in 2,574 and 2,626 angles, and torch's CPU f32
    functions from jnp's in 9,963 and 10,121."""
    u = np.random.default_rng(0).random(200_000).astype(np.float32)
    phi = (np.float32(2.0 * np.pi) * u).astype(np.float32)
    jc, js = np.asarray(jnp.cos(jnp.asarray(phi))), np.asarray(jnp.sin(jnp.asarray(phi)))
    c, s = pt.cos_sin(torch.from_numpy(phi))
    assert (int((jc != c.numpy()).sum()), int((js != s.numpy()).sum())) == (2574, 2626)
    tp = torch.from_numpy(phi)
    assert (int((jc != torch.cos(tp).numpy()).sum()),
            int((js != torch.sin(tp).numpy()).sum())) == (9963, 10121)


def _plane_pair(S, D, **kw):
    """The escape-only plane of tests/test_pathtrace.py:540-562 in both
    packages: every bounce escapes to the constant background."""
    out = []
    for mg, Mat, Light, Cam, Scn, sfm, prep, extra in (
            (jax_meshes, JaxMaterialConfig, JaxLightConfig, JaxCameraConfig, JaxSceneConfig,
             jax_scenes.scene_from_meshes, jax_renderer.prepare, {}),
            (meshes, MaterialConfig, LightConfig, CameraConfig, SceneConfig,
             scenes.scene_from_meshes, prepare, dict(device="cpu"))):
        mats = (Mat(base_color=(140.0, 90.0, 200.0)),)
        light = Light(position=(0.5, 6.0, 0.3), intensity=60.0)
        scene = sfm([(mg.make_plane(extent=8.0, y=-1.0, density=2), 0)], mats, light, **extra)
        cfg = Scn(materials=mats, light=light,
                  camera=Cam(position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=16,
                             height=16))
        cfg = _replace(cfg, faithful=False, det_dtype="float32", ray_tile=64, gi_samples=S,
                       gi_depth=D, background=PLANE_BG, gi_wave="off", **kw)
        out.append(prep(cfg, scene=scene))
    return out


def _gradcheck_pair(size, S, D, **kw):
    jscene, jcfg = jax_scenes.gradcheck_scene(size, size)
    scene, cfg = scenes.gradcheck_scene(size, size, device="cpu")
    jscene = jscene._replace(light_intensity=jnp.float32(GI_LIGHT))
    scene = scene._replace(light_intensity=torch.tensor(GI_LIGHT))
    rkw = dict(faithful=False, det_dtype="float32", gi_samples=S, gi_depth=D, gi_wave="off",
               **kw)
    return (jax_renderer.prepare(_replace(jcfg, **rkw), scene=jscene),
            prepare(_replace(cfg, **rkw), scene=scene))


def _jax_eager(jprep):
    with jax.disable_jit():
        return np.asarray(jax_renderer.render(jprep), np.float32)


@pytest.mark.parametrize("trav", sorted(SEGMENT_TRAVERSALS))
def test_segments_escape_plane_bitwise_vs_op_by_op_jax(trav):
    jprep, prep = _plane_pair(3, 2, gi_sample_batch=2, **SEGMENT_TRAVERSALS[trav])
    img = render(prep).numpy()
    _bitwise(img, _jax_eager(jprep))
    assert img.min() > 0.0


@pytest.mark.parametrize("trav", sorted(SEGMENT_TRAVERSALS))
def test_segments_depth0_bitwise_vs_op_by_op_jax(trav):
    """gi_depth 0 is next-event estimation alone: no sampled direction."""
    jprep, prep = _gradcheck_pair(16, 2, 0, **SEGMENT_TRAVERSALS[trav])
    img = render(prep).numpy()
    _bitwise(img, _jax_eager(jprep))
    assert img.max() > 0.0


@pytest.mark.parametrize("trav", ["persistent_fused", "csr"])
def test_segments_gradcheck_vs_jax(trav):
    """Bounces on a scene with occlusion.  Against op-by-op JAX only the
    cos/sin of a sampled angle can differ (in its last bit, which moves a
    bounce's hit point): more than 99% of pixels bitwise (measured: all
    but 1 of 576) and the means within 0.5%.  Against jitted JAX, whose
    Cramer contraction flips some bounces' topology, the JAX package's
    statistical rule with its share lowered from 97% to 85% of pixels
    within 1e-5 (measured 88.7%) and the means within 2%."""
    jprep, prep = _gradcheck_pair(24, 2, 2, gi_specular=True, **SEGMENT_TRAVERSALS[trav])
    img = render(prep).numpy()
    eager = _jax_eager(jprep)
    same_bits = (img.view(np.uint32) == eager.view(np.uint32)).all(axis=-1)
    assert same_bits.mean() > 0.99, same_bits.mean()
    np.testing.assert_allclose(img.mean(), eager.mean(), rtol=0.005)
    want = np.asarray(jax_renderer.render(jprep))
    same = (np.abs(img - want) <= 1e-5).all(axis=-1)
    assert same.mean() > 0.85, same.mean()
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=0.02)
    assert img.max() > 0.1


def test_sample_batch_changes_no_bit():
    _, prep = _gradcheck_pair(16, 3, 1, traversal="packed", scheduler="persistent")
    one = render(prep._replace(cfg=_replace(prep.cfg, gi_sample_batch=1)))
    three = render(prep._replace(cfg=_replace(prep.cfg, gi_sample_batch=3)))
    assert torch.equal(one, three)


def _eligibility_cases():
    """(name, port cfg, JAX cfg) pairs of configs the port serves."""
    size = 8
    turbo = apply_turbo(_replace(scenes.serial_scene_config(size, size), gi_samples=4), "serial")
    jturbo = jax_apply_turbo(_replace(jax_scenes.serial_scene_config(size, size),
                                      gi_samples=4), "serial")
    par = apply_turbo(_replace(scenes.parallel_scene_config(size, size), gi_samples=2),
                      "parallel")
    jpar = jax_apply_turbo(_replace(jax_scenes.parallel_scene_config(size, size),
                                    gi_samples=2), "parallel")
    base = _replace(scenes.serial_scene_config(size, size), faithful=False, gi_samples=2)
    jbase = _replace(jax_scenes.serial_scene_config(size, size), faithful=False, gi_samples=2)
    cases = [("turbo_serial", turbo, jturbo), ("turbo_parallel", par, jpar),
             ("csr", base, jbase)]
    for name, kw in (("wave_off", dict(gi_wave="off")), ("wave_on", dict(gi_wave="on")),
                     ("tiled", dict(scheduler="tiled")),
                     ("no_specular", dict(gi_specular=False)),
                     ("no_fuse", dict(gi_fuse_nee=False))):
        cases.append((name, _replace(turbo, **kw), _replace(jturbo, **kw)))
        cases.append((name + "_parallel", _replace(par, **kw), _replace(jpar, **kw)))
    cases.append(("csr_on", _replace(base, gi_wave="on"), _replace(jbase, gi_wave="on")))
    return cases


@pytest.mark.parametrize("case", _eligibility_cases(), ids=lambda c: c[0])
def test_gi_wave_eligibility_and_spec_follow_jax(case):
    _, cfg, jcfg = case
    jscene = jax_scenes.build_scene(jcfg)
    scene = scenes.build_scene(cfg, device="cpu")
    jprep = types.SimpleNamespace(cfg=jcfg, scene=jscene)
    try:
        want = jax_pt.gi_wave_eligible(jprep)
    except ValueError:
        with pytest.raises(ValueError):
            pt.gi_wave_eligible(cfg)
        with pytest.raises(ValueError):
            prepare(cfg, device="cpu")
        return
    assert pt.gi_wave_eligible(cfg) == want
    assert pt.use_gi_wave_spec(scene, cfg.render) == jax_pt.use_gi_wave_spec(jscene,
                                                                             jcfg.render)
    setup = prepare(cfg, device="cpu").setup
    assert setup.gi_wave == want and not setup.wave


@pytest.mark.parametrize("change,match", [
    (dict(dtype="float64"), "dtype"),
    (dict(shadow_samples=4, light_radius=0.5), "area-light soft shadows"),
    (dict(gi_env_nee=True), "gi_env_nee"),
    ("extra_lights", "extra lights"),
    ("transmissive", "transmissive"),
])
def test_refused_gi_features_raise(change, match):
    cfg = apply_turbo(_replace(scenes.serial_scene_config(8, 8), gi_samples=2), "serial")
    if change == "extra_lights":
        cfg = dataclasses.replace(cfg, extra_lights=(LightConfig(),))
    elif change == "transmissive":
        cfg = dataclasses.replace(cfg, materials=(MaterialConfig(transmissive=True),))
    else:
        cfg = _replace(cfg, **change)
    with pytest.raises(NotImplementedError, match=match):
        prepare(cfg, device="cpu")


@pytest.mark.parametrize("change", [dict(texture="checker"), dict(normal_mode="smooth")])
def test_gi_appearance_options_render(change):
    """Textures and smooth normals, refused before the port served them,
    render path-traced on the turbo serial scene through the GI wave: its
    plain version against op-by-op JAX's wave by the statistical rule (more
    than 90% of pixels within 1e-3; bounces sample directions), and against
    the port's segment integrator likewise."""
    cfg = apply_turbo(_replace(scenes.serial_scene_config(8, 8), gi_samples=2), "serial")
    jcfg = jax_apply_turbo(_replace(jax_scenes.serial_scene_config(8, 8), gi_samples=2),
                           "serial")
    kw = dict(gi_depth=1, background=(40.0, 30.0, 20.0), **change)
    prep = prepare(_replace(cfg, **kw), device="cpu")
    jprep = jax_renderer.prepare(_replace(jcfg, **kw))
    assert prep.setup.gi_wave
    img = render(prep).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_pt._render_pt_wave(jprep))
    seg = render(prep._replace(cfg=_replace(prep.cfg, gi_wave="off"))).numpy()
    assert np.isfinite(img).all() and img.max() > 0
    for other in (want, seg):
        assert ((np.abs(img - other) <= 1e-3).all(axis=-1)).mean() > 0.9


def test_ring_tracer_and_faithful_refused():
    _, prep = _gradcheck_pair(8, 1, 1, traversal="packed", scheduler="persistent")
    rays = pt.camera_rays(prep.cfg.camera, device="cpu")
    g, m = prep.packed.arrays, prep.packed.meta
    with pytest.raises(NotImplementedError, match="tracer"):
        pt.pathtrace_rays(rays, prep.scene, g, m, prep.cfg, tracer=object())
    with pytest.raises(ValueError, match="faithful"):
        pt.pathtrace_rays(rays, prep.scene, g, m, _replace(prep.cfg, faithful=True))
    with pytest.raises(ValueError, match="faithful"):
        prepare(_replace(scenes.serial_scene_config(8, 8), gi_samples=1), device="cpu")
