"""Extra point lights and area-light soft shadows on the port's Whitted
render and fit, against the JAX package (mirrors tests/test_lights.py
without its sharded, ring and config-file tests, and
tests/test_shading_features.py's area-light tests).

* `light_sample_offsets` is the JAX package's set bit for bit.
* The bounce loop with two extra lights and a 16-sample area light on
  the gradcheck scene at 32x32 is bitwise op-by-op JAX's, over the CSR
  grid (kernel B's plain version) and the packed grid's persistent wave
  (kernel C's: the primary trace, then one compacted shadow trace per
  light and sample batch); so are the serial variant with the fused
  primary shadow and two extra lights, and an area light under soft
  visibility, at 16x16.  The image is byte-equal across
  shadow_sample_batch 1, 4 and 16 (and 5 samples in batches of 1, 4
  and 8).
* The JAX package's properties: no extra light and a zero-intensity one
  change no bit; an extra light only adds and casts its own shadow; the
  serial variant is symmetric in which light is the primary (rtol 1e-5,
  atol 1e-3, the JAX test's tolerance); `prepare` attaches
  cfg.extra_lights to a scene without them; area lights give a penumbra,
  on every light, deterministically; the CSR and packed soft shadows
  agree to the JAX test's tolerance (rtol 1e-4, atol 5e-2); a radius
  with one sample is the point light bit for bit.
* The extra light's position gradient: against eager jax.grad of the JAX
  image_loss at test_torch_grad.py's tolerance (rtol 1e-4, atol
  1e-6 * max|g|), and against central differences (the JAX test's rtol
  2e-2); the loss to rtol 1e-6, as there.
* A checkpoint the JAX package saved with its npz backend from a scene
  with extra lights restores into the port's fit, whose first loss is
  the restored params'; `cli fit --extra-light` and `cli render` with
  the light options run.
* `check_supported` accepts the features, with dtype="float64" too (an
  area light in float64 prepares and renders through the bounce loop);
  the Whitted wave is ineligible with them.
"""

import builtins
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import LightConfig as JaxLightConfig  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import shade as jax_shade  # noqa: E402
from ray_tracer_tpu.opt import checkpoint as jax_ckpt  # noqa: E402
from ray_tracer_tpu.opt import fit as jax_fit  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import LightConfig, apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import shade  # noqa: E402
from ray_tracer_tpu_torch.opt import checkpoint, fit  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import (  # noqa: E402
    check_supported,
    prepare,
    render,
    whitted_wave_eligible,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA = ((-4.0, 6.0, -2.0, 1.0), (0.0, 5.0, 5.0, 0.5))
AREA = dict(light_radius=0.5, shadow_samples=16)


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))


def _lights(cls, extra):
    return tuple(cls(position=e[:3], intensity=e[3]) for e in extra)


def _prep(size=16, extra=(), **render_kw):
    """The port's gradcheck scene with cfg.extra_lights (attached by
    prepare, as the JAX package's test attaches them to its scene)."""
    scene, cfg = scenes.gradcheck_scene(size, size, device="cpu")
    cfg = dataclasses.replace(_replace(cfg, **render_kw),
                              extra_lights=_lights(LightConfig, extra))
    return prepare(cfg, scene=scene)


def _jax_prep(size=16, extra=(), **render_kw):
    scene, cfg = jax_scenes.gradcheck_scene(size, size)
    cfg = dataclasses.replace(_replace(cfg, **render_kw),
                              extra_lights=_lights(JaxLightConfig, extra))
    return jax_renderer.prepare(cfg, scene=scene)


def _img(prep):
    return render(prep).numpy()


def _jax_eager(jprep):
    with jax.disable_jit():
        return np.asarray(jax_renderer.render(jprep), np.float32)


def test_light_sample_offsets_bitwise_vs_jax():
    for n, radius in ((1, 0.5), (4, 0.8), (5, 0.6), (16, 0.5), (37, 2.0)):
        got = shade.light_sample_offsets(n, radius)
        assert got.dtype == np.float32 and got.shape == (n, 3)
        _bitwise(got, jax_shade.light_sample_offsets(n, radius))
    offs = shade.light_sample_offsets(16, 0.5)
    np.testing.assert_allclose(np.linalg.norm(offs, axis=1), 0.5, rtol=1e-5)
    assert np.linalg.norm(offs.mean(axis=0)) < 0.1
    np.testing.assert_array_equal(shade.light_sample_offsets(1, 0.5), np.zeros((1, 3)))


# (size, traversal, extra lights, render options): the JAX side takes all
# of an area light's samples in one batch (its image does not depend on
# the batch, and the eager while loop then runs once a light)
BITWISE_CASES = {
    "csr_extras_area_32": (32, dict(traversal="csr", det_dtype="float32"), EXTRA, AREA),
    "packed_extras_area_32": (32, dict(traversal="packed", scheduler="persistent",
                                       det_dtype="float32"), EXTRA, AREA),
    "packed_serial_fused_extras_16": (16, dict(traversal="packed", scheduler="persistent",
                                               det_dtype="float32", shading="serial"),
                                      EXTRA, {}),
    "csr_serial_area_soft_visibility_16": (16, dict(traversal="csr", shading="serial"), (),
                                           dict(light_radius=0.8, shadow_samples=4,
                                                soft_visibility=0.1)),
}


@pytest.mark.parametrize("case", sorted(BITWISE_CASES))
def test_lights_bitwise_vs_op_by_op_jax(case):
    size, trav, extra, area = BITWISE_CASES[case]
    prep = _prep(size, extra, **trav, **area)
    got = _img(prep)
    jbatch = dict(shadow_sample_batch=area["shadow_samples"]) if area else {}
    _bitwise(got, _jax_eager(_jax_prep(size, extra, **trav, **area, **jbatch)))
    assert np.isfinite(got).all()


def test_shadow_sample_batch_bitwise_invariant():
    """The JAX test's 5 samples in batches of 1, 4 and 8 on the CSR grid,
    and 16 samples in batches of 1, 4 and 16 with two extra lights on the
    persistent wave: the same bytes."""
    kw = dict(light_radius=0.6, shadow_samples=5)
    seq = _img(_prep(shadow_sample_batch=1, **kw))
    for b in (4, 8):
        np.testing.assert_array_equal(seq, _img(_prep(shadow_sample_batch=b, **kw)))
    trav = dict(faithful=False, traversal="packed", scheduler="persistent", **AREA)
    seq = _img(_prep(24, EXTRA, shadow_sample_batch=1, **trav))
    for b in (4, 16):
        np.testing.assert_array_equal(seq, _img(_prep(24, EXTRA, shadow_sample_batch=b,
                                                       **trav)))


def test_no_or_dark_extra_light_changes_no_bit():
    base = _img(_prep())
    np.testing.assert_array_equal(base, _img(_prep(extra=())))
    np.testing.assert_array_equal(base, _img(_prep(extra=((0.0, 8.0, 0.0, 0.0),))))


def test_extra_light_brightens_and_casts_its_own_shadow():
    base = _img(_prep())
    lit = _img(_prep(extra=(EXTRA[0],)))
    assert np.isfinite(lit).all()
    assert (lit >= base - 1e-4).all()
    assert (lit > base + 1e-3).any()
    np.testing.assert_array_equal(lit, _img(_prep(extra=(EXTRA[0],))))
    # its own shadow: the extra light's term, unshadowed (shadow_scale 1)
    # less shadowed, is positive somewhere
    unshadowed = _img(_prep(extra=(EXTRA[0],), shadow_scale=1.0)) - _img(_prep(shadow_scale=1.0))
    assert ((unshadowed - (lit - base)) > 1e-3).any()


def test_serial_light_symmetry():
    """Serial shading applies one formula to every light, so swapping which
    light is the primary changes the image by rounding alone."""
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    l1, l2 = LightConfig((4.0, 6.0, 2.0), 0.7), LightConfig((-3.0, 5.0, -1.0), 1.3)

    def img(primary, extra):
        c = dataclasses.replace(_replace(cfg, shading="serial", faithful=False),
                                light=primary, extra_lights=(extra,))
        sc = scene._replace(light_pos=torch.tensor(primary.position),
                            light_intensity=torch.tensor(primary.intensity))
        return _img(prepare(c, scene=sc))

    np.testing.assert_allclose(img(l1, l2), img(l2, l1), rtol=1e-5, atol=1e-3)


def test_prepare_attaches_cfg_extra_lights_to_provided_scene():
    prep = _prep(extra=(EXTRA[0],))
    assert prep.scene.extra_light_pos is not None
    _bitwise(prep.scene.extra_light_pos.numpy(), np.array([EXTRA[0][:3]], np.float32))
    assert (_img(prep) > _img(_prep()) + 1e-3).any()
    # a scene that carries extra lights keeps its own
    own = prep.scene._replace(extra_light_pos=prep.scene.extra_light_pos + 1.0)
    kept = prepare(prep.cfg, scene=own).scene
    assert torch.equal(kept.extra_light_pos, own.extra_light_pos)
    # a config scene gets them from cfg
    cfg = dataclasses.replace(scenes.serial_scene_config(8, 8),
                              extra_lights=_lights(LightConfig, EXTRA))
    built = prepare(cfg, device="cpu").scene
    _bitwise(built.extra_light_intensity.numpy(), np.array([1.0, 0.5], np.float32))


def test_soft_shadows_penumbra_and_every_light():
    hard = _img(_prep())
    soft = _img(_prep(light_radius=0.8, shadow_samples=8))
    lit = _img(_prep(shadow_scale=1.0))
    assert np.isfinite(soft).all() and not np.array_equal(hard, soft)
    assert ((soft > hard + 1e-4) & (soft < lit - 1e-4)).any(), "no penumbra pixels"
    np.testing.assert_array_equal(soft, _img(_prep(light_radius=0.8, shadow_samples=8)))
    hard_x = _img(_prep(extra=(EXTRA[0],)))
    soft_x = _img(_prep(extra=(EXTRA[0],), light_radius=0.8, shadow_samples=4))
    assert np.isfinite(soft_x).all() and not np.array_equal(hard_x, soft_x)


def test_soft_shadows_packed_persistent_close_to_csr():
    a = _img(_prep(light_radius=0.8, shadow_samples=4))
    b = _img(_prep(light_radius=0.8, shadow_samples=4, traversal="packed",
                   scheduler="persistent", wave=256))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-2)


def test_point_light_defaults_unchanged():
    np.testing.assert_array_equal(_img(_prep()), _img(_prep(light_radius=0.8)))


def test_features_served_and_the_waves_ineligible():
    turbo = apply_turbo(scenes.parallel_scene_config(8, 8), "parallel")
    assert check_supported(turbo) is True
    for cfg in (dataclasses.replace(turbo, extra_lights=_lights(LightConfig, EXTRA[:1])),
                _replace(turbo, **AREA)):
        assert check_supported(cfg) is False and not whitted_wave_eligible(cfg)
        with pytest.raises(ValueError, match="ineligible"):
            check_supported(_replace(cfg, whitted_wave="on"))
    scene = scenes.build_scene(turbo, device="cpu")
    with_lights = scene._replace(extra_light_pos=torch.ones((1, 3)),
                                 extra_light_intensity=torch.ones((1,)))
    assert not whitted_wave_eligible(turbo, with_lights)
    f64 = _replace(turbo, dtype="float64", **AREA)
    assert check_supported(f64) is False and not whitted_wave_eligible(f64)
    prep = prepare(f64, device="cpu")  # an area light in float64 prepares, takes no wave
    assert not prep.setup.wave and render(prep).dtype == torch.float64
    with pytest.raises(ValueError, match="faithful"):
        check_supported(_replace(scenes.serial_scene_config(8, 8), **AREA))


@pytest.fixture(scope="module")
def grad_pair():
    """The gradcheck scene at 16x16 with one extra light in both packages,
    a random target, and eager jax.grad of the JAX image_loss."""
    prep, jprep = _prep(extra=(EXTRA[0],)), _jax_prep(extra=(EXTRA[0],))
    target = np.random.default_rng(0).uniform(0, 80, size=(16, 16, 3)).astype(np.float32)

    def jloss_of(params):
        return jax_fit.image_loss(params, jprep.scene, jprep.grid.arrays, jprep.grid.meta,
                                  jprep.cfg, jnp.asarray(target))

    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(jloss_of)(jax_fit.split_scene(jprep.scene))
    return prep, jprep, target, float(jloss), jgrads


def _port_loss(prep, target, params):
    return fit.image_loss(params, prep.scene, prep.grid.arrays, prep.grid.meta, prep.cfg,
                          torch.from_numpy(target))


@pytest.mark.parametrize("field", ["extra_light_pos", "extra_light_intensity", "light_pos"])
def test_extra_light_gradients_match_eager_jax(grad_pair, field):
    prep, _, target, jloss, jgrads = grad_pair
    params = fit.split_scene(prep.scene)
    leaf = getattr(params, field).detach().clone().requires_grad_(True)
    loss = _port_loss(prep, target, params._replace(**{field: leaf}))
    (g,) = torch.autograd.grad(loss, [leaf])
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-6)
    want = np.asarray(getattr(jgrads, field))
    assert np.isfinite(g.numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max()))


def test_extra_light_position_gradient_fd(grad_pair):
    prep, _, target, _, _ = grad_pair
    params = fit.split_scene(prep.scene)
    val = params.extra_light_pos
    tangent = torch.zeros_like(val)
    tangent[0, 0] = 1.0
    leaf = val.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_port_loss(prep, target, params._replace(extra_light_pos=leaf)),
                               [leaf])
    eps = 1e-3

    def f(v):
        with torch.no_grad():
            return float(_port_loss(prep, target, params._replace(extra_light_pos=v)))

    fd = (f(val + eps * tangent) - f(val - eps * tangent)) / (2 * eps)
    np.testing.assert_allclose(float((g * tangent).sum()), fd, rtol=2e-2, atol=1e-7)


def test_jax_checkpoint_with_extra_lights_restores_into_fit(grad_pair, tmp_path, monkeypatch):
    """A JAX npz checkpoint of the extra-light scene (orbax made
    unimportable) gives the port's fit its params, extra lights among
    them, in field order; the resumed fit's first loss is the port's loss
    at the restored params."""
    prep, jprep, target, _, _ = grad_pair
    real_import = builtins.__import__

    def no_orbax(name, *a, **k):
        if name.startswith("orbax"):
            raise ImportError("forced npz backend")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_orbax)
    monkeypatch.delitem(sys.modules, "orbax.checkpoint", raising=False)
    jp = jax_fit.split_scene(jprep.scene)
    jp = jp._replace(extra_light_pos=jp.extra_light_pos + 0.25,
                     extra_light_intensity=jp.extra_light_intensity * 1.5)
    _, init = jax_fit.make_train_step(jprep.grid.meta, jprep.cfg)
    d = str(tmp_path / "ck")
    jax_ckpt.save_checkpoint(d, jp, init(jp), step_num=2)
    with open(os.path.join(d, "step_2", "meta.json")) as fh:
        assert json.load(fh)["backend"] == "npz"
    trainable = ("extra_light_pos", "extra_light_intensity", "light_pos")
    _, init_t = fit.make_train_step(prep.grid.meta, prep.cfg, trainable=trainable)
    params, opt = init_t(fit.split_scene(prep.scene))
    restored, _ = checkpoint.restore_checkpoint(d, {"params": params, "opt_state": opt})
    for f in fit.SceneParams._fields:
        a, b = getattr(restored, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _bitwise(a.numpy(), np.asarray(b))
    with torch.no_grad():
        want = float(_port_loss(prep, target, restored))
    _, losses = fit.fit(prep, torch.from_numpy(target), steps=4, lr=1e-2, trainable=trainable,
                        checkpoint_dir=d, resume=True, log_every=0)
    assert len(losses) == 2
    np.testing.assert_allclose(losses[0], want, rtol=1e-6)
    assert losses[1] < losses[0]


def test_cli_light_options(tmp_path):
    """`cli render` with two extra lights and an area light writes the
    in-process render's bytes; JAX's option rules hold; `cli fit
    --extra-light` runs, and so does `cli fit --config` with a light option."""
    from ray_tracer_tpu_torch import cli

    out = tmp_path / "soft.ppm"
    cli.main(["render", "--scene", "serial", "--width", "8", "--turbo", "--device", "cpu",
              "--extra-light=-5,-5,2,128", "--extra-light", "0,5,5,96",
              "--light-radius", "0.5", "--out", str(out)])
    cfg = dataclasses.replace(
        _replace(apply_turbo(scenes.serial_scene_config(8, 8), "serial"), faithful=False,
                 **AREA),
        extra_lights=(LightConfig((-5.0, -5.0, 2.0), 128.0), LightConfig((0.0, 5.0, 5.0), 96.0)))
    want = tonemap_u8(render(prepare(cfg, device="cpu")).numpy())
    assert (read_ppm(str(out)) == want).all()
    for bad in (["--shadow-samples", "4"], ["--light-radius", "0.5", "--shadow-samples", "1"],
                ["--extra-light", "1,2"]):
        with pytest.raises(SystemExit):
            cli.main(["render", "--width", "8", "--device", "cpu", "--out", str(out)] + bad)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "fit", "--scene", "gradcheck",
            "--width", "8", "--steps", "2", "--device", "cpu"]
    ok = subprocess.run(base + ["--extra-light=-4,6,-2", "--trainable",
                                "kd,extra_light_pos,extra_light_intensity"],
                        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert set(json.loads(ok.stdout.strip().splitlines()[-1])) == {"first_loss", "last_loss"}
    # a scene config file (served since dtype="float64" and config files
    # came to the port) takes the light options on top
    from ray_tracer_tpu_torch.config import save_scene_config

    path = str(tmp_path / "scene.json")
    save_scene_config(scenes.serial_scene_config(8, 8), path)
    ok = subprocess.run(base[:4] + ["--config", path, "--steps", "2", "--device", "cpu",
                                    "--extra-light=-4,6,-2", "--trainable", "kd"],
                        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert set(json.loads(ok.stdout.strip().splitlines()[-1])) == {"first_loss", "last_loss"}
