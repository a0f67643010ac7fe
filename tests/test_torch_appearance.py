"""The appearance epilogues of the port (textures, environment maps, smooth
normals) against the JAX package: the lookups and the normals op by op,
and the Whitted bounce loop that applies them.

* `texture_factor` (checker and image) and `sample_texture_image` are
  bitwise op-by-op JAX's on random uvs, has-uv flags and hits, wrapped
  coordinates and the saturating cast's specials (inf, NaN) among them (a
  NaN is compared as a NaN, whatever its payload).
* `sample_env_image`: bitwise on a constant map (it returns the constant),
  `atan2` bitwise on every direction (of the lookup's strided operands:
  torch's vectorized atan2 of contiguous ones differs in the last bit on
  about 16% of them, and that count is reported), and bitwise on the
  directions where torch's `acos` gives jnp's bits; where it does not
  (about 18% of random unit directions, ROADMAP.md's parity hazards), the
  count is reported.
* `vertex_normals` is bitwise JAX's `.at[faces].add` (serial and parallel
  conventions); `interpolate_normal`, `cramer_bg_safe` and
  `Scene.interpolate_uv` are bitwise JAX's.
* The bounce loop on the serial scene with a checker texture, an image
  texture, smooth normals, an environment map, and all three (on the CSR
  grid and the turbo packed grid): against jitted JAX by the 2-count
  rule, under 1% of pixels more than 2 counts apart (0 measured).
* `check_supported` takes the three options and still refuses smooth
  normals and environment maps with faithful=True, as the JAX renderer
  does; a config with an environment map never takes the Whitted wave.
* `cli render` with the appearance options writes the PNG of the
  in-process render.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import intersect as jax_intersect  # noqa: E402
from ray_tracer_tpu.ops import shade as jax_shade  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import intersect, shade  # noqa: E402
from ray_tracer_tpu_torch.render import renderer  # noqa: E402

RNG = np.random.default_rng(9)
SIZE = 32


def _bitwise(got, want):
    """Equal bits, NaN payloads aside (a NaN is compared as a NaN)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.uint32), want[keep].view(np.uint32))


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _uvs(n):
    uv = (RNG.random((n, 2)) * 6.0 - 3.0).astype(np.float32)
    uv[:6, 0] = [np.inf, -np.inf, np.nan, 1e30, -1e30, 0.5]
    return uv


@pytest.mark.parametrize("mode", ["checker", "image"])
def test_texture_factor_bitwise_vs_jax(mode):
    n = 20_000
    uv = _uvs(n)
    has_uv = RNG.random(n) < 0.8
    hit = RNG.random(n) < 0.9
    tex = RNG.random((5, 7, 3)).astype(np.float32)
    with jax.disable_jit():
        want = jax_scenes.texture_factor(jnp.asarray(uv), jnp.asarray(has_uv),
                                         jnp.asarray(hit), mode, 3.0, jnp.asarray(tex),
                                         jnp.float32)
    got = scenes.texture_factor(_t(uv), _t(has_uv), _t(hit), mode, 3.0, _t(tex),
                                torch.float32)
    assert tuple(got.shape) == want.shape
    _bitwise(got.numpy(), want)
    if mode == "image":
        with jax.disable_jit():
            want = jax_scenes.sample_texture_image(jnp.asarray(tex), jnp.asarray(uv))
        _bitwise(scenes.sample_texture_image(_t(tex), _t(uv)).numpy(), want)


def _unit_dirs(n):
    v = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    v[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1]]
    return v


def test_env_lookup_on_a_constant_map_is_the_constant():
    d = _unit_dirs(20_000)
    env = np.broadcast_to(np.array([40.0, 30.0, 20.0], np.float32), (4, 8, 3)).copy()
    got = scenes.sample_env_image(_t(env), _t(d)).numpy()
    with jax.disable_jit():
        want = jax_scenes.sample_env_image(jnp.asarray(env), jnp.asarray(d))
    _bitwise(got, want)
    _bitwise(got, np.broadcast_to(env[0, 0], got.shape))


def test_env_lookup_parity_counts():
    """Random unit directions through a non-constant map: atan2 gives jnp's
    bits everywhere; acos does not on some directions, and the lookup is
    bitwise JAX's wherever it does.  The differing lanes are counted."""
    n = 200_000
    d = _unit_dirs(n)
    env = (RNG.random((16, 32, 3)) * 255.0).astype(np.float32)
    y = np.clip(d[:, 1], -1.0, 1.0)
    with jax.disable_jit():
        want = np.asarray(jax_scenes.sample_env_image(jnp.asarray(env), jnp.asarray(d)))
        j_atan = np.asarray(jnp.arctan2(jnp.asarray(d[:, 2]), jnp.asarray(d[:, 0])))
        j_acos = np.asarray(jnp.arccos(jnp.asarray(y)))
    dt = _t(d)
    got = scenes.sample_env_image(_t(env), dt).numpy()
    # the lookup's own operands: strided columns of the (R, 3) directions
    _bitwise(torch.atan2(dt[:, 2], dt[:, 0]).numpy(), j_atan)
    contiguous = torch.atan2(_t(d[:, 2]), _t(d[:, 0])).numpy()
    print(f"contiguous atan2 differs on "
          f"{int((contiguous.view(np.uint32) != j_atan.view(np.uint32)).sum())} of {n}")
    acos_same = torch.acos(_t(y)).numpy().view(np.uint32) == j_acos.view(np.uint32)
    _bitwise(got[acos_same], want[acos_same])
    differing = int((got.view(np.uint32) != want.view(np.uint32)).any(axis=1).sum())
    print(f"acos differs on {int((~acos_same).sum())} of {n} directions; "
          f"{differing} lookups differ from JAX's")
    assert (~acos_same).mean() < 0.25 and differing <= int((~acos_same).sum())
    np.testing.assert_allclose(got, want, rtol=0, atol=255.0 * 2e-4)


@pytest.mark.parametrize("serial", [True, False])
def test_vertex_normals_bitwise_vs_jax(serial):
    cfg = scenes.serial_scene_config(8, 8)
    scene = scenes.build_scene(cfg, device="cpu")
    jscene = jax_scenes.build_scene(jax_scenes.serial_scene_config(8, 8))
    got = shade.vertex_normals(scene.verts, scene.faces, serial)
    with jax.disable_jit():
        want = jax_shade.vertex_normals(jscene.verts, jscene.faces, serial)
    assert got.dtype == torch.float32 and got.device == scene.verts.device
    _bitwise(got.numpy(), want)


def test_barycentrics_normals_and_uvs_bitwise_vs_jax():
    """cramer_bg_safe (with invalid lanes and a degenerate triangle),
    interpolate_normal and Scene.interpolate_uv on random hits of the
    serial scene."""
    scene = scenes.build_scene(scenes.serial_scene_config(8, 8), device="cpu")
    jscene = jax_scenes.build_scene(jax_scenes.serial_scene_config(8, 8))
    n = 20_000
    tri = RNG.integers(0, scene.num_faces, n)
    o = (RNG.normal(size=(n, 3)) * 3.0).astype(np.float32)
    d = RNG.normal(size=(n, 3)).astype(np.float32)
    valid = RNG.random(n) < 0.8
    o[:3] = np.inf
    v = scene.verts.numpy()[scene.faces.numpy()[tri]]
    v[5] = v[5, 0]  # a degenerate triangle: A == 0
    args = (o, d, v[:, 0], v[:, 1], v[:, 2], valid)
    hb, hg = intersect.cramer_bg_safe(*map(_t, args))
    with jax.disable_jit():
        jhb, jhg = jax_intersect.cramer_bg_safe(*map(jnp.asarray, args))
    _bitwise(hb.numpy(), jhb)
    _bitwise(hg.numpy(), jhg)
    vn = shade.vertex_normals(scene.verts, scene.faces, False)
    tri_t = _t(tri)
    with jax.disable_jit():
        jvn = jax_shade.vertex_normals(jscene.verts, jscene.faces, False)
        want_n = jax_shade.interpolate_normal(jvn, jscene.faces, jnp.asarray(tri), jhb, jhg)
        want_uv = jscene.interpolate_uv(jnp.asarray(tri), jhb, jhg)
    _bitwise(shade.interpolate_normal(vn, scene.faces, tri_t, hb, hg).numpy(), want_n)
    _bitwise(scene.interpolate_uv(tri_t, hb, hg).numpy(), want_uv)


def _images():
    tex = np.random.default_rng(1).random((16, 16, 3)).astype(np.float32)
    env = (np.random.default_rng(2).random((8, 16, 3)) * 255.0).astype(np.float32)
    return tex, env


WHITTED = {
    "checker": (dict(texture="checker"), False, False),
    "image": (dict(texture="image"), True, False),
    "smooth": (dict(normal_mode="smooth"), False, False),
    "env": ({}, False, True),
    "all": (dict(normal_mode="smooth", texture="image"), True, True),
    "all_turbo": (dict(normal_mode="smooth", texture="image"), True, True),
}


@pytest.mark.parametrize("case", list(WHITTED))
def test_bounce_loop_vs_jitted_jax(case):
    kw, with_tex, with_env = WHITTED[case]
    cfg = scenes.serial_scene_config(SIZE, SIZE)
    jcfg = jax_scenes.serial_scene_config(SIZE, SIZE)
    if case.endswith("turbo"):
        cfg, jcfg = apply_turbo(cfg, "serial"), jax_apply_turbo(jcfg, "serial")
    cfg, jcfg = _replace(cfg, faithful=False, **kw), _replace(jcfg, faithful=False, **kw)
    tex, env = _images()
    extra = {}
    jscene = jax_scenes.build_scene(jcfg)
    if with_tex:
        extra["texture_image"] = tex
        jscene = jscene._replace(texture_image=jnp.asarray(tex))
    if with_env:
        extra["env_image"] = env
        jscene = jscene._replace(env_image=jnp.asarray(env))
    v, f, fm, uv, uvf = scenes.scene_numpy_arrays(cfg)
    scene = scenes.scene_from_numpy(v, f, fm, cfg.materials, cfg.light, uv, uvf, device="cpu",
                                    **extra)
    prep = renderer.prepare(cfg, scene=scene)
    assert not prep.setup.wave
    assert (prep.setup.vn is not None) == (cfg.render.normal_mode == "smooth")
    img = renderer.render(prep).numpy()
    want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg, scene=jscene)))
    a, b = tonemap_u8(img).astype(int), tonemap_u8(want).astype(int)
    over = (np.abs(a - b).max(axis=-1) > 2).mean()
    assert over < 0.01, over
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    # each feature changes the image
    plain = renderer.render(renderer.prepare(_replace(cfg, normal_mode="face", texture="none"),
                                             scene=scene._replace(env_image=None))).numpy()
    assert (np.abs(img - plain) > 1.0).any()


def test_faithful_smooth_and_env_raise_and_env_leaves_the_wave():
    base = scenes.serial_scene_config(8, 8)
    with pytest.raises(ValueError, match="faithful=False"):
        renderer.check_supported(_replace(base, normal_mode="smooth"))
    _, env = _images()
    scene = scenes.build_scene(base, device="cpu")._replace(env_image=_t(env))
    with pytest.raises(ValueError, match="faithful=False"):
        renderer.prepare(base, scene=scene)
    with pytest.raises(ValueError, match="unknown texture mode"):
        renderer.check_supported(_replace(base, texture="marble"))
    wave = apply_turbo(scenes.parallel_scene_config(8, 8), "parallel")
    assert renderer.whitted_wave_eligible(wave)
    pscene = scenes.build_scene(wave, device="cpu")
    assert not renderer.whitted_wave_eligible(wave, pscene._replace(env_image=_t(env)))
    with pytest.raises(ValueError, match="ineligible"):
        renderer.whitted_wave_eligible(_replace(wave, whitted_wave="on"),
                                       pscene._replace(env_image=_t(env)))
    with pytest.raises(ValueError, match="texture_image"):
        renderer.render(renderer.prepare(_replace(base, faithful=False, texture="image"),
                                         device="cpu"))


def test_cli_render_appearance_to_png(tmp_path):
    """`cli render --smooth-normals --texture image --texture-file x.ppm
    --env-file y.png --out z.png` writes the PNG of the in-process render
    of the same config and scene (the texture read as u8 / 255, the map in
    color units)."""
    from ray_tracer_tpu_torch import cli
    from ray_tracer_tpu_torch.io.png import read_png, write_png
    from ray_tracer_tpu_torch.io.ppm import write_ppm

    tex_u8 = np.random.default_rng(3).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    env_u8 = np.random.default_rng(4).integers(0, 256, (8, 16, 3), dtype=np.uint8)
    write_ppm(str(tmp_path / "tex.ppm"), tex_u8, already_u8=True)
    write_png(str(tmp_path / "sky.png"), env_u8, already_u8=True)
    out = tmp_path / "app.png"
    cli.main(["render", "--scene", "serial", "--width", "16", "--turbo", "--smooth-normals",
              "--texture", "image", "--texture-scale", "2", "--texture-file",
              str(tmp_path / "tex.ppm"), "--env-file", str(tmp_path / "sky.png"),
              "--device", "cpu", "--out", str(out)])
    cfg = _replace(apply_turbo(scenes.serial_scene_config(16, 16), "serial"),
                   normal_mode="smooth", texture="image", texture_scale=2.0)
    v, f, fm, uv, uvf = scenes.scene_numpy_arrays(cfg)
    scene = scenes.scene_from_numpy(
        v, f, fm, cfg.materials, cfg.light, uv, uvf, device="cpu",
        texture_image=tex_u8.astype(np.float32) / np.float32(255.0),
        env_image=env_u8.astype(np.float32))
    img = renderer.render(renderer.prepare(cfg, scene=scene)).numpy()
    np.testing.assert_array_equal(read_png(str(out)), tonemap_u8(img))
