"""The pixel debugger (render/debug.py) and banded rendering
(render/resilient.py) against the JAX package (mirrors
tests/test_resilient.py and the single-device trace_pixel checks).

* `trace_pixel` gives JAX's dict, key for key and value for value
  (op-by-op JAX: the floats are the same traversal arithmetic), for hit
  and missed pixels of the serial scene over the csr grid (faithful) and
  the turbo packed grid, and the gradcheck scene under parallel shading;
  its record is the full frame's at that pixel; smooth normals, an area
  light and mesh= raise NotImplementedError.
* `render_banded` is byte-equal to `render()` (float32 and float64
  rays, spp 2, csr and packed), for any band count; a failing `band_fn`
  is retried and the image is unchanged; exhausted retries raise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import debug as jax_debug  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render import debug, resilient  # noqa: E402
from ray_tracer_tpu_torch.render.aov import render_aovs  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render, render_rays  # noqa: E402


def _rep(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _gradcheck_pair():
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    jscene, jcfg = jax_scenes.gradcheck_scene(16, 16)
    return (prepare(_rep(cfg, ray_tile=64), scene=scene),
            jax_renderer.prepare(_rep(jcfg, ray_tile=64), scene=jscene))


PAIRS = {
    "serial_csr": lambda: (prepare(scenes.serial_scene_config(32, 32), device="cpu"),
                           jax_renderer.prepare(jax_scenes.serial_scene_config(32, 32))),
    "serial_turbo": lambda: (
        prepare(apply_turbo(scenes.serial_scene_config(32, 32), "serial"), device="cpu"),
        jax_renderer.prepare(jax_apply_turbo(jax_scenes.serial_scene_config(32, 32),
                                             "serial"))),
    "gradcheck_parallel": _gradcheck_pair,
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_trace_pixel_equals_jax(name):
    prep, jprep = PAIRS[name]()
    w = prep.cfg.camera.width
    aovs = render_aovs(prep)
    hits = 0
    for x, y in ((w // 2, w // 2), (0, 0), (w // 3, w // 2 + 1), (w - 1, w // 4)):
        got = debug.trace_pixel(prep, x, y)
        with jax.disable_jit():
            want = jax_debug.trace_pixel(jprep, x, y)
        assert got == want, {k: (got.get(k), want.get(k)) for k in want
                             if got.get(k) != want.get(k)}
        hits += got["hit"]
        if name != "serial_csr":  # the AOV trace is the primary policy's, early exit
            assert got["hit"] == bool(aovs["hit"][y, x])
            if got["hit"]:
                assert got["tri_id"] == int(aovs["tri_id"][y, x])
                assert got["t"] == float(aovs["depth"][y, x])
    assert hits >= 1


def test_trace_pixel_refusals():
    """Smooth normals and an area light are refused, as in the JAX package;
    mesh= is served: on a one-rank ring ((1, 1) "rays", "tris") the trace
    is the single-device one with steps -1 (tests/test_torch_ring.py holds
    it on 2 and 4 ranks)."""
    from torch_ranks import one_rank_group

    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    prep, _ = _gradcheck_pair()
    for kw in (dict(normal_mode="smooth", faithful=False),
               dict(shadow_samples=4, light_radius=0.5, faithful=False)):
        with pytest.raises(NotImplementedError):
            debug.trace_pixel(prep._replace(cfg=_rep(prep.cfg, **kw)), 8, 8)
    want = debug.trace_pixel(prep, 8, 8)
    with one_rank_group():
        got = debug.trace_pixel(prep, 8, 8, mesh=make_mesh(1, ("rays", "tris"), shape=(1, 1),
                                                           devices="cpu"))
    assert got["steps"] == -1 and want["hit"]
    assert {k: v for k, v in got.items() if k != "steps"} == {
        k: v for k, v in want.items() if k != "steps"}


BANDED = {
    "gradcheck_csr": lambda: _gradcheck_pair()[0],
    "serial_turbo_f64": lambda: prepare(_rep(apply_turbo(scenes.serial_scene_config(24, 20),
                                                         "serial"), dtype="float64"),
                                        device="cpu"),
    "parallel_csr_spp2": lambda: prepare(_rep(scenes.parallel_scene_config(10, 10), spp=2),
                                         device="cpu"),
}


@pytest.mark.parametrize("name", list(BANDED))
def test_banded_equals_render(name):
    prep = BANDED[name]()
    single = render(prep).numpy().astype(np.float32)
    for bands in (1, 3, 8):
        banded = resilient.render_banded(prep, bands=bands)
        assert banded.dtype == np.float32 and banded.shape == single.shape
        np.testing.assert_array_equal(banded, single)


def test_transient_failures_are_retried():
    prep = _gradcheck_pair()[0]
    calls = {"n": 0}

    @torch.no_grad()
    def flaky(band_rays):
        calls["n"] += 1
        if calls["n"] in (1, 3):  # the first attempt of two bands fails
            raise RuntimeError("transient device error")
        return render_rays(band_rays, prep.scene, prep.grid.arrays, prep.grid.meta,
                           prep.cfg.render).numpy()

    img = resilient.render_banded(prep, bands=4, retries=2, backoff_s=0.0, band_fn=flaky)
    np.testing.assert_array_equal(img, render(prep).numpy())
    assert calls["n"] == 6  # 4 bands + 2 retries


def test_exhausted_retries_raise():
    prep = _gradcheck_pair()[0]

    def always_fail(_):
        raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError, match="permanent"):
        resilient.render_banded(prep, bands=2, retries=1, backoff_s=0.0, band_fn=always_fail)
