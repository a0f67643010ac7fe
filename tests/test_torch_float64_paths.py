"""dtype="float64" on the port's other paths, against the JAX package
(x64 on: tests/conftest.py).

* The turbo serial scene (kernel C's march on float32 copies of the
  float64 rays, the epilogue on the float64 rays), the turbo parallel
  scene's 3-bounce loop (the Whitted wave refuses float64), at spp 1 and
  2: the float64 images bitwise op-by-op JAX's.
* The GI segment integrator (S 2, D 1; the GI wave refuses float64) on
  float64 camera rays, persistent fused and csr, against op-by-op JAX at
  16x16 by test_torch_pathtrace.py's rule for bounces.
* The fit under float64: the first loss and its gradients against eager
  jax.grad of the JAX image_loss (the loss to rtol 1e-6, each leaf to
  test_torch_grad.py's rtol 1e-4, atol 1e-6 * max|g|), and 4 Adam steps'
  losses against the JAX fit's to rtol 1e-4 (test_torch_fit.py's rule).
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
from ray_tracer_tpu.opt import fit as jax_fit  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt import fit  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402


def _rep(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


CASES = {
    "turbo_serial": (lambda m: m.serial_scene_config(16, 16), "serial", {}),
    "turbo_parallel_3_bounces": (lambda m: m.parallel_scene_config(16, 16), "parallel", {}),
    "turbo_parallel_spp2": (lambda m: m.parallel_scene_config(8, 8), "parallel", dict(spp=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_f64_render_bitwise_vs_jax_eager(case):
    make, family, kw = CASES[case]
    cfg, jcfg = make(scenes), make(jax_scenes)
    if family:
        cfg, jcfg = apply_turbo(cfg, family), jax_apply_turbo(jcfg, family)
    cfg, jcfg = _rep(cfg, dtype="float64", **kw), _rep(jcfg, dtype="float64", **kw)
    prep = prepare(cfg, device="cpu")
    assert not prep.setup.wave and not prep.setup.gi_wave
    img = render(prep).numpy()
    assert img.dtype == np.float64
    with jax.disable_jit():
        want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg)))
    _bitwise(img, want)
    assert (img.max(axis=-1) > 0).mean() > 0.05


# the gradcheck scene's light (intensity 1 in 0-255 units) is too dim for
# GI; both packages take test_torch_pathtrace.py's brighter one
GI_LIGHT = 40.0


@pytest.mark.parametrize("traversal", [
    dict(traversal="packed", scheduler="persistent", gi_fuse_nee=True),
    dict(traversal="csr"),
], ids=["persistent_fused", "csr"])
def test_f64_gi_segments_vs_jax_eager(traversal):
    """The segment integrator (S 2, D 1) on float64 camera rays.  Against
    op-by-op JAX only the cos/sin of a sampled angle can differ (ROADMAP.md,
    parity hazards), as on float32 rays: test_torch_pathtrace.py's rule,
    more than 99% of pixels bitwise and the means within 0.5%."""
    jscene, jcfg = jax_scenes.gradcheck_scene(16, 16)
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    jscene = jscene._replace(light_intensity=jnp.float32(GI_LIGHT))
    scene = scene._replace(light_intensity=torch.tensor(GI_LIGHT))
    kw = dict(faithful=False, det_dtype="float32", dtype="float64", gi_samples=2, gi_depth=1,
              gi_wave="auto", **traversal)
    prep = prepare(_rep(cfg, **kw), scene=scene)
    assert not prep.setup.gi_wave
    img = render(prep).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_renderer.render(jax_renderer.prepare(_rep(jcfg, **kw),
                                                                   scene=jscene)))
    assert img.dtype == want.dtype == np.float64
    same_bits = (img.view(np.uint64) == want.view(np.uint64)).all(axis=-1)
    assert same_bits.mean() > 0.99, same_bits.mean()
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=0.005)
    assert (img.max(axis=-1) > 0).mean() > 0.5


@pytest.fixture(scope="module")
def f64_pair():
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    jscene, jcfg = jax_scenes.gradcheck_scene(16, 16)
    return (prepare(_rep(cfg, dtype="float64", ray_tile=64), scene=scene),
            jax_renderer.prepare(_rep(jcfg, dtype="float64", ray_tile=64), scene=jscene))


def test_f64_fit_loss_and_gradients_vs_jax_grad(f64_pair):
    prep, jprep = f64_pair
    target = np.random.default_rng(0).uniform(0, 80, size=(16, 16, 3)).astype(np.float32)

    def jloss_of(params):
        return jax_fit.image_loss(params, jprep.scene, jprep.grid.arrays, jprep.grid.meta,
                                  jprep.cfg, jnp.asarray(target))

    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(jloss_of)(jax_fit.split_scene(jprep.scene))
    params = fit.split_scene(prep.scene)
    leaves = {f: getattr(params, f).clone().requires_grad_(True)
              for f in ("verts", "base_color", "kd", "ks", "spec_alpha", "ka", "light_pos")}
    loss = fit.image_loss(params._replace(**leaves), prep.scene, prep.grid.arrays,
                          prep.grid.meta, prep.cfg, torch.from_numpy(target), dda=prep.dda)
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (name, _), g in zip(leaves.items(), grads):
        want = np.asarray(getattr(jgrads, name))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=name)


def test_f64_fit_history_matches_jax(f64_pair):
    prep, jprep = f64_pair
    target = render(prep)
    p = fit.split_scene(prep.scene)
    moved = prep._replace(scene=fit.merge_scene(p._replace(kd=p.kd * 1.6), prep.scene))
    _, losses = fit.fit(moved, target, steps=4, lr=5e-2, trainable=("kd",), log_every=0)
    jp = jax_fit.split_scene(jprep.scene)
    jmoved = jprep._replace(scene=jax_fit.merge_scene(jp._replace(kd=jp.kd * 1.6),
                                                      jprep.scene))
    _, jlosses = jax_fit.fit(jmoved, jax_renderer.render(jprep), steps=4, lr=5e-2,
                             trainable=("kd",), log_every=0)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
