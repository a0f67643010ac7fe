"""The cross-depth Whitted wave of the port (ops/whitted_wave.py, kernel
E's plain version on the CPU) against the JAX package.

* Against `ray_tracer_tpu/ops/whitted_wave.py` run op by op
  (`jax.disable_jit()`), whose wave of 16x16 = 256 lanes serves every
  pixel at once, the colors are bitwise equal: the turbo parallel scene
  (its pump of 10 changes no color) and a mirror scene with a background.
* Against jitted JAX (`_render_whitted_wave`) and against the port's own
  bounce loop (whitted_wave="off"), the tolerances of
  tests/test_whitted_wave.py: rtol 1e-5 with atol 1e-4 on the mirror
  scenes and 2e-2 on the serial scene (the forward blend associates the
  depths' colors otherwise than the deepest-first fold, and jitted XLA
  contracts the Cramer arithmetic), and the u8 images more than 2 counts
  apart on under 1% of pixels.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import LightConfig as JaxLightConfig  # noqa: E402
from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import whitted_wave as jax_wave  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import LightConfig, apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import whitted_wave as wave  # noqa: E402
from ray_tracer_tpu_torch.ops.camera import camera_rays  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import (  # noqa: E402
    prepare,
    render,
    whitted_wave_eligible,
)

SIZE = 16
MIRROR_TOL = dict(rtol=1e-5, atol=1e-4)
SERIAL_TOL = dict(rtol=1e-5, atol=2e-2)
BACKGROUND = (25.0, 10.0, 5.0)


def _replace(cfg, camera=None, **kw):
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))
    if camera:
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, **camera))
    return cfg


def _image_rule(a, b):
    a, b = tonemap_u8(np.asarray(a)), tonemap_u8(np.asarray(b))
    diff = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.01


def _bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))


def _mirror_render_kw(mb=3, **kw):
    """tests/test_whitted_wave.py's mirror configuration of the gradcheck
    scene: packed grid, persistent wave, fused shadow, the wave on."""
    return dict(faithful=False, det_dtype="float32", traversal="packed",
                scheduler="persistent", wave=256, pump=2, max_bounces=mb, fused_shadow=True,
                whitted_wave="auto", **kw)


def _jax_mirror(mb=3, camera=None, **kw):
    scene, cfg = jax_scenes.gradcheck_scene(SIZE, SIZE)
    mats = scene.materials._replace(reflective=jnp.asarray([False, True]),
                                    km=jnp.asarray([0.0, 0.6], jnp.float32))
    cfg = _replace(cfg, camera, **_mirror_render_kw(mb, **kw))
    return jax_renderer.prepare(cfg, scene=scene._replace(materials=mats))


def _port_mirror(mb=3, camera=None, **kw):
    scene, cfg = scenes.gradcheck_scene(SIZE, SIZE, device="cpu")
    mats = scene.materials._replace(reflective=torch.tensor([False, True]),
                                    km=torch.tensor([0.0, 0.6]))
    cfg = _replace(cfg, camera, **_mirror_render_kw(mb, **kw))
    return prepare(cfg, scene=scene._replace(materials=mats))


@pytest.fixture(scope="module")
def parallel_turbo():
    """The turbo parallel config at 16x16 in both packages and the port's
    wave image."""
    cfg = apply_turbo(scenes.parallel_scene_config(SIZE, SIZE), "parallel")
    prep = prepare(cfg, device="cpu")
    jcfg = jax_apply_turbo(jax_scenes.parallel_scene_config(SIZE, SIZE), "parallel")
    return prep, jax_renderer.prepare(jcfg), render(prep)


@pytest.fixture(scope="module")
def mirror():
    prep = _port_mirror(background=BACKGROUND)
    return prep, _jax_mirror(background=BACKGROUND), render(prep)


def _jax_eager(jprep):
    """The JAX wave run op by op; at 16x16 its wave width min(wave, 256)
    holds every pixel."""
    assert jax_renderer.whitted_wave_eligible(jprep)
    with jax.disable_jit():
        return np.asarray(jax_renderer.render(jprep), np.float32)


def test_parallel_turbo_bitwise_vs_op_by_op_jax(parallel_turbo):
    prep, jprep, img = parallel_turbo
    assert whitted_wave_eligible(prep.cfg, prep.scene)
    assert prep.cfg.render.pump == 10 and prep.cfg.render.max_bounces == 3
    _bitwise(img.numpy(), _jax_eager(jprep))
    assert float(img.max()) > 1000.0


def test_mirror_scene_bitwise_vs_op_by_op_jax(mirror):
    prep, jprep, img = mirror
    _bitwise(img.numpy(), _jax_eager(jprep))
    # the background reaches the image through misses and escaping mirrors
    assert (img.numpy() == np.asarray(BACKGROUND, np.float32)).all(axis=-1).any()


def test_parallel_turbo_vs_jitted_jax(parallel_turbo):
    prep, jprep, img = parallel_turbo
    want = np.asarray(jax_renderer._render_whitted_wave(jprep))
    np.testing.assert_allclose(img.numpy(), want, **MIRROR_TOL)
    _image_rule(img.numpy(), want)


def test_mirror_scene_vs_jitted_jax(mirror):
    _, jprep, img = mirror
    want = np.asarray(jax_renderer._render_whitted_wave(jprep))
    np.testing.assert_allclose(img.numpy(), want, **MIRROR_TOL)
    _image_rule(img.numpy(), want)


def test_serial_scene_vs_jitted_jax_and_bounce_loop():
    """Serial shading (unnormalized h, the light intensity, ambient after
    the shadow scale), the exact zero-direct shadow skip and the shadow
    direction quirk, with whitted_wave="on"."""
    base = apply_turbo(scenes.serial_scene_config(SIZE, SIZE), "serial")
    prep = prepare(_replace(base, whitted_wave="on"), device="cpu")
    img = render(prep).numpy()
    jcfg = jax_apply_turbo(jax_scenes.serial_scene_config(SIZE, SIZE), "serial")
    jprep = jax_renderer.prepare(_replace(jcfg, whitted_wave="on"))
    want = np.asarray(jax_renderer._render_whitted_wave(jprep))
    np.testing.assert_allclose(img, want, **SERIAL_TOL)
    _image_rule(img, want)
    loop = render(prep._replace(cfg=_replace(base, whitted_wave="off"))).numpy()
    np.testing.assert_allclose(img, loop, **SERIAL_TOL)
    _image_rule(img, loop)


def test_wave_vs_bounce_loop(parallel_turbo, mirror):
    """The port's wave against the port's own bounce loop (kernel C's plain
    march at every depth, the deepest-first fold)."""
    for prep, img in ((parallel_turbo[0], parallel_turbo[2]), (mirror[0], mirror[2])):
        loop = render(prep._replace(cfg=_replace(prep.cfg, whitted_wave="off")))
        np.testing.assert_allclose(img.numpy(), loop.numpy(), **MIRROR_TOL)
        _image_rule(img.numpy(), loop.numpy())


@pytest.mark.parametrize("camera,mb", [(None, 2), (dict(aperture=0.2, focus_distance=3.0), 1)],
                         ids=["spp2", "dof"])
def test_spp_and_dof_vs_bounce_loop(camera, mb):
    """spp 2 (the queue holds the subsamples, folded subsample-major) and
    thin-lens depth of field with spp 2, as tests/test_whitted_wave.py
    checks them in JAX."""
    prep = _port_mirror(mb=mb, camera=camera, spp=2)
    assert whitted_wave_eligible(prep.cfg, prep.scene)
    img = render(prep)
    assert img.shape == (SIZE, SIZE, 3)
    loop = render(prep._replace(cfg=_replace(prep.cfg, whitted_wave="off")))
    np.testing.assert_allclose(img.numpy(), loop.numpy(), **MIRROR_TOL)
    _image_rule(img.numpy(), loop.numpy())
    if camera:  # the lens blurs: the image differs from the pinhole's
        pin = render(prep._replace(cfg=_replace(prep.cfg, camera=dict(aperture=0.0))))
        assert not torch.equal(pin, img)


def test_tile_and_counters(parallel_turbo):
    """The plain version traced in ray_tile chunks gives the same colors,
    and its counters are consistent: every entered primary and every
    rearm is a segment, every vertex a resolved slot, no lane capped."""
    prep, _, img = parallel_turbo
    tiled = render(prep._replace(cfg=_replace(prep.cfg, ray_tile=37)))
    assert torch.equal(tiled, img)
    rc = prep.cfg.render
    mat9, tri9 = wave.build_wave_tables(prep.scene)
    rays = camera_rays(prep.cfg.camera, device="cpu")
    g, m = prep.packed.arrays, prep.packed.meta

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    cnt = dict(capped_out=z(1), passes_out=z(1), tested_out=z(rays.count),
               touched_out=z(m.n_blocks), slots_out=z(g.slot_tri.shape[0]),
               events_out=z(len(wave.EVENTS)))
    col = wave.whitted_wave_plain(
        rays, prep.scene.light_pos, prep.scene.light_intensity, mat9, tri9, g, m,
        max_bounces=rc.max_bounces, serial=False, gate0=rc.primary_gate(),
        gate_b=rc.bounce_gate(), eps=rc.shadow_eps, smint=rc.shadow_mint(),
        shadow_scale=rc.shadow_scale, **cnt)
    assert torch.equal(col, img.reshape(-1, 3))
    primaries, vertices, shadows, reflections, mirrors = cnt["events_out"].tolist()
    assert int(cnt["capped_out"]) == 0
    assert 0 < vertices <= primaries + mirrors and shadows <= vertices
    assert mirrors <= reflections <= vertices
    assert int(cnt["slots_out"].sum()) <= vertices and int(cnt["slots_out"].sum()) > 0
    rows = int(cnt["tested_out"].sum())
    assert 0 < int(cnt["passes_out"]) <= rows * m.block_tris
    assert int(((cnt["touched_out"] & 2) != 0).sum()) > 0


def test_build_wave_tables_equal_jax(parallel_turbo):
    prep, jprep, _ = parallel_turbo
    want = jax_wave.build_wave_tables(jprep.scene)
    got = wave.build_wave_tables(prep.scene)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _bitwise(g.numpy(), w)


def test_prepare_builds_the_wave_tables_once(parallel_turbo, monkeypatch):
    """`prepare` derives kernel E's tables for a config that takes the wave
    and `render` reads them from there; a config that does not take the
    wave gets none."""
    from ray_tracer_tpu_torch.render import renderer

    prep, _, img = parallel_turbo
    for g, w in zip(prep.wave, wave.build_wave_tables(prep.scene)):
        assert torch.equal(g, w)

    def refuse(scene):
        raise AssertionError("render rebuilt the wave's tables")

    monkeypatch.setattr(renderer, "build_wave_tables", refuse)
    assert torch.equal(render(prep), img)
    off = _replace(scenes.parallel_scene_config(8, 8), whitted_wave="off")
    assert prepare(off, device="cpu").wave is None


def _eligibility_table():
    turbo = dict(traversal="packed", scheduler="persistent", faithful=False,
                 whitted_wave="auto")
    return [
        ("parallel", {}, None, {}),
        ("parallel", turbo, None, {}),
        ("parallel", dict(turbo, spp=2), None, {}),
        ("parallel", turbo, dict(aperture=0.25), {}),
        ("parallel", dict(turbo, spp=3), dict(aperture=0.25), {}),
        ("parallel", dict(turbo, scheduler="tiled"), None, {}),
        ("parallel", dict(turbo, traversal="csr"), None, {}),
        ("parallel", dict(turbo, det_dtype="float64"), None, {}),
        ("parallel", dict(turbo, normal_mode="smooth"), None, {}),
        ("parallel", dict(turbo, soft_visibility=0.1), None, {}),
        ("parallel", dict(turbo, soft_primary=0.1), None, {}),
        ("parallel", dict(turbo, shadow_samples=4, light_radius=0.5), None, {}),
        ("parallel", dict(turbo, shadow_samples=4), None, {}),
        ("parallel", dict(turbo, gi_samples=1), None, {}),
        ("parallel", dict(turbo, texture="checker"), None, {}),
        ("parallel", dict(turbo, texture="checker"), None, dict(uvs=True)),
        ("parallel", turbo, None, dict(extra_light=True)),
        ("parallel", turbo, None, dict(env=True)),
        ("serial", turbo, None, {}),
        ("serial", dict(turbo, whitted_wave="off"), None, {}),
    ]


def test_eligibility_follows_jax():
    """whitted_wave_eligible over a table of configs, against JAX's (which
    reads the uvs, the environment map and the extra lights from the
    prepared scene)."""
    for name, rkw, camera, skw in _eligibility_table():
        mk = f"{name}_scene_config"
        cfg = _replace(getattr(scenes, mk)(8, 8), camera, **rkw)
        jcfg = _replace(getattr(jax_scenes, mk)(8, 8), camera, **rkw)
        uvs = np.zeros((3, 2), np.float32) if skw.get("uvs") else None
        if skw.get("extra_light"):
            cfg = dataclasses.replace(cfg, extra_lights=(LightConfig((1.0, 2.0, 3.0), 1.0),))
            jcfg = dataclasses.replace(jcfg, extra_lights=(JaxLightConfig((1.0, 2.0, 3.0), 1.0),))
        env = np.ones((2, 4, 3), np.float32) if skw.get("env") else None
        jscene = types.SimpleNamespace(
            uvs=uvs, env_image=env,
            extra_light_pos=np.ones((1, 3), np.float32) if skw.get("extra_light") else None)
        pscene = types.SimpleNamespace(uvs=None if uvs is None else torch.from_numpy(uvs),
                                       env_image=None if env is None else torch.from_numpy(env))
        want = jax_renderer.whitted_wave_eligible(types.SimpleNamespace(cfg=jcfg, scene=jscene))
        assert whitted_wave_eligible(cfg, pscene) == want, (name, rkw, camera, skw)
    with pytest.raises(ValueError, match="ineligible"):
        whitted_wave_eligible(_replace(scenes.parallel_scene_config(8, 8), whitted_wave="on"))


def test_sharded_queue_and_cuda_wrapper_refuse(parallel_turbo):
    prep, _, _ = parallel_turbo
    mat9, tri9 = wave.build_wave_tables(prep.scene)
    args = (prep.scene.light_pos, prep.scene.light_intensity, mat9, tri9,
            prep.packed.arrays, prep.packed.meta)
    with pytest.raises(NotImplementedError, match="sharded"):
        wave.whitted_wave_trace(*args, camera=prep.cfg.camera, max_bounces=3, serial=False,
                                pix_offset=0, pix_stride=2, queue_len=128)
    before = wave.whitted_wave_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        wave.whitted_wave_cuda(prep.cfg.camera, *args, max_bounces=3, serial=False)
    assert wave.whitted_wave_cuda.launches == before
    # the JAX loop's schedule knobs change no color
    rc = prep.cfg.render
    col = wave.whitted_wave_trace(*args, camera=prep.cfg.camera, max_bounces=rc.max_bounces,
                                  serial=False, gate0=rc.primary_gate(),
                                  gate_b=rc.bounce_gate(), eps=rc.shadow_eps,
                                  smint=rc.shadow_mint(), shadow_scale=rc.shadow_scale,
                                  wave=7, pump=3, refill_retries=0, max_iters=5)
    assert torch.equal(col, parallel_turbo[2].reshape(-1, 3))



def _plain_counted(rays, prep):
    """The plain wave over `rays` with every counter."""
    rc = prep.cfg.render
    mat9, tri9 = prep.wave
    g, m = prep.packed.arrays, prep.packed.meta

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    cnt = dict(capped_out=z(1), passes_out=z(1), tested_out=z(rays.count),
               touched_out=z(m.n_blocks), slots_out=z(g.slot_tri.shape[0]),
               events_out=z(len(wave.EVENTS)))
    col = wave.whitted_wave_plain(
        rays, prep.scene.light_pos, prep.scene.light_intensity, mat9, tri9, g, m,
        max_bounces=rc.max_bounces, serial=rc.serial_shading, gate0=rc.primary_gate(),
        gate_b=rc.bounce_gate(), eps=rc.shadow_eps, smint=rc.shadow_mint(),
        quirk=rc.shadow_dir_away_from_light(), shadow_scale=rc.shadow_scale,
        bg=tuple(rc.background), **cnt)
    return col, cnt


@pytest.mark.parametrize("seed", [0, 1])
def test_colors_and_counters_do_not_depend_on_the_order(parallel_turbo, mirror, seed):
    """The plain wave over a shuffled order of the queue positions,
    unshuffled after, gives the same colors and counters bit for bit:
    kernel E's refill serves positions in whatever order its lanes free
    up, and is held to the plain version on that."""
    for prep in (parallel_turbo[0], mirror[0]):
        rays = camera_rays(prep.cfg.camera, device="cpu")
        col, cnt = _plain_counted(rays, prep)
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(rays.count))
        scol, scnt = _plain_counted(type(rays)(*(x[perm] for x in rays)), prep)
        back = torch.empty_like(perm)
        back[perm] = torch.arange(rays.count)
        _bitwise(scol[back].numpy(), col.numpy())
        for key in cnt:
            want = cnt[key]
            got = scnt[key][back] if key == "tested_out" else scnt[key]
            assert torch.equal(got, want), key
        assert int(cnt["events_out"][0]) > 0


def test_prepare_settles_the_frame_and_render_reads_nothing(parallel_turbo, monkeypatch):
    """`prepare` settles the frame's facts once: the wave flag, kernel E's
    camera launch and the grid's and light's launch values (equal to
    what the wrappers would read from the device).  Kernel E's launch
    parameters then come from host values alone, and `render` neither
    decides the wave again nor reads a tensor back (`_host_vec3`,
    `.cpu()`, `.item()`, `.tolist()` and the two makers refuse)."""
    from ray_tracer_tpu_torch.ops import traverse_packed
    from ray_tracer_tpu_torch.ops.camera import camera_launch
    from ray_tracer_tpu_torch.render import renderer

    prep, _, img = parallel_turbo
    setup = prep.setup
    assert setup.wave and setup.cfg is prep.cfg
    g = prep.packed.arrays
    assert setup.consts == traverse_packed.launch_consts(g, prep.scene.light_pos,
                                                         prep.scene.light_intensity)
    want_cam = camera_launch(prep.cfg.camera, prep.cfg.render.spp, device="cpu")
    assert setup.cam[:5] == want_cam[:5] and torch.equal(setup.cam.table, want_cam.table)

    def refuse(*a, **k):
        raise AssertionError("a frame-time read or re-derivation")

    for mod, name in ((traverse_packed, "_host_vec3"), (renderer, "check_supported"),
                      (renderer, "launch_consts"), (renderer, "camera_launch"),
                      (wave, "launch_consts"), (wave, "camera_launch")):
        monkeypatch.setattr(mod, name, refuse)
    rc = prep.cfg.render
    mat9, tri9 = prep.wave
    params, cparams = wave._launch_params(
        setup.cam, setup.consts, prep.packed.meta, n_slots=g.slot_tri.shape[0],
        n_faces=tri9.shape[0], n_mats=mat9.shape[0], max_bounces=rc.max_bounces,
        serial=False, gate0=0.0, gate_b=rc.bounce_gate(), eps=rc.shadow_eps,
        smint=rc.shadow_mint(), quirk=False, shadow_scale=rc.shadow_scale, bg=(0.0, 0.0, 0.0))
    assert tuple(params.m.lower) == setup.consts.lower and params.m.n_rays == 16 * 16
    assert tuple(cparams.w) == setup.cam.basis[3] and cparams.n_sub == 1
    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    assert torch.equal(render(prep), img)


# pow inputs of the 64x64 turbo parallel wave on which the card's torch.pow
# (libdevice powf, as kernel E's) and the CPU's differ, with the card's
# results, from chip_smoke.py's card_vs_cpu phase on an NVIDIA H100
POW_ON_THE_CARD = [(0.07957273721694946, 1.25, 0.042262520641088486),
                   (0.06625868380069733, 1.25, 0.033616576343774796),
                   (0.05103904381394386, 1.25, 0.0242592953145504)]


def test_cpu_pow_is_correctly_rounded_where_the_card_differs():
    """The 64x64 wave's 25 card-vs-CPU floats come from pow alone: on
    these inputs the CPU's torch.pow gives the correctly rounded f32 (the
    double root of the f32 inputs, rounded), and the card's is one ulp
    away, within its documented 2 ulp."""
    for base, e, card in POW_ON_THE_CARD:
        b32, e32, c32 = np.float32(base), np.float32(e), np.float32(card)
        want = np.float32(float(b32) ** float(e32))
        got = torch.pow(torch.tensor([b32]), torch.tensor([e32])).numpy()[0]
        assert got.view(np.uint32) == want.view(np.uint32)
        assert abs(int(c32.view(np.int32)) - int(want.view(np.int32))) == 1
