"""AOV buffers and ambient occlusion (render/aov.py) against the JAX
package's (mirrors tests/test_aov.py's single-device tests).

* `hemisphere_dirs` is JAX's point set bit for bit.
* `render_aovs` on the gradcheck scene (ray_tile 64: the CPU's chunks,
  csr and packed) and the serial scene: hit, tri_id and material_id equal
  to JAX's, and depth, normal and position bitwise op-by-op JAX's; the
  JAX test's properties (miss sentinels, unit normals).
* `render_ao` (8 and 16 samples) bitwise op-by-op JAX's, csr and packed;
  sky pixels open, an occluded and an open region, no self-occlusion
  under serial shading.
* mesh= and ring= raise NotImplementedError (one device).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import aov as jax_aov  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render import aov  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare  # noqa: E402


def _rep(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _gradcheck_pair(**kw):
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    jscene, jcfg = jax_scenes.gradcheck_scene(16, 16)
    return (prepare(_rep(cfg, ray_tile=64, **kw), scene=scene),
            jax_renderer.prepare(_rep(jcfg, ray_tile=64, **kw), scene=jscene))


PAIRS = {
    "gradcheck_csr": lambda: _gradcheck_pair(),
    "gradcheck_packed": lambda: _gradcheck_pair(faithful=False, traversal="packed"),
    "serial_turbo": lambda: (
        prepare(apply_turbo(scenes.serial_scene_config(16, 16), "serial"), device="cpu"),
        jax_renderer.prepare(jax_apply_turbo(jax_scenes.serial_scene_config(16, 16),
                                             "serial"))),
}


def test_hemisphere_dirs_bitwise():
    for n in (1, 8, 16, 32, 37):
        _bitwise(aov.hemisphere_dirs(n), jax_aov.hemisphere_dirs(n))
    d = aov.hemisphere_dirs(32)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-5)
    assert (d[:, 2] > 0).all() and np.linalg.norm(d[:, :2].mean(axis=0)) < 0.15


@pytest.mark.parametrize("name", list(PAIRS))
def test_aov_buffers_vs_jax(name):
    prep, jprep = PAIRS[name]()
    got = {k: v.numpy() for k, v in aov.render_aovs(prep).items()}
    with jax.disable_jit():
        want = {k: np.asarray(v) for k, v in jax_aov.render_aovs(jprep).items()}
    assert set(got) == set(want)
    for k in ("hit", "tri_id", "material_id", "depth", "normal", "position"):
        _bitwise(got[k], want[k])
    h, w = prep.cfg.camera.height, prep.cfg.camera.width
    hit = got["hit"]
    assert got["depth"].shape == (h, w) and got["normal"].shape == (h, w, 3)
    assert hit.any() and not hit.all()
    assert np.isinf(got["depth"][~hit]).all() and np.isfinite(got["depth"][hit]).all()
    assert (got["tri_id"][~hit] == -1).all() and (got["material_id"][hit] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(got["normal"][hit], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name,samples", [("gradcheck_csr", 8), ("gradcheck_packed", 16),
                                          ("serial_turbo", 8)])
def test_render_ao_vs_jax(name, samples):
    prep, jprep = PAIRS[name]()
    ao = aov.render_ao(prep, samples=samples, radius=1.0).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_aov.render_ao(jprep, samples=samples, radius=1.0))
    _bitwise(ao, want)
    hit = aov.render_aovs(prep)["hit"].numpy()
    assert ao.shape == hit.shape and (ao >= 0).all() and (ao <= 1).all()
    np.testing.assert_array_equal(ao[~hit], 1.0)  # sky: fully open
    if name.startswith("gradcheck"):
        assert (ao[hit] < 0.95).any() and (ao[hit] > 0.95).any()
    np.testing.assert_array_equal(ao, aov.render_ao(prep, samples=samples,
                                                    radius=1.0).numpy())


def test_render_ao_serial_no_self_occlusion():
    """Serial shading's primary gate is 0; the occlusion rays gate t > eps,
    or each would take its own triangle again and read AO ~0.5."""
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    prep = prepare(_rep(cfg, shading="serial", faithful=False, ray_tile=64), scene=scene)
    assert (aov.render_ao(prep, samples=8, radius=1.0).numpy() > 0.99).any()


def test_multi_device_arguments_raise():
    """The multi-device arguments are served: ring=True without a mesh is
    the single-device path (as in the JAX package), and on a one-rank group
    mesh= gives one device's buffers bitwise, and mesh= with ring=True (a
    one-shard ring over ("rays", "tris") of (1, 1)) their ids and flags
    exactly and their floats to 1e-5 (tests/test_torch_ring.py holds the
    ring on 2 and 4 ranks)."""
    from torch_ranks import one_rank_group

    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    prep, _ = _gradcheck_pair()
    single = aov.render_aovs(prep)
    ao_single = aov.render_ao(prep, samples=4)
    for k, v in aov.render_aovs(prep, ring=True).items():
        assert torch.equal(v, single[k]), k
    assert torch.equal(aov.render_ao(prep, samples=4, ring=True), ao_single)
    with one_rank_group() as mesh:
        got = aov.render_aovs(prep, mesh=mesh)
        ao = aov.render_ao(prep, samples=4, mesh=mesh)
        two = make_mesh(1, ("rays", "tris"), shape=(1, 1), devices="cpu")
        ring = aov.render_aovs(prep, mesh=two, ring=True)
        ring_ao = aov.render_ao(prep, samples=4, mesh=two, ring=True)
    for k, v in single.items():
        assert torch.equal(got[k], v), k
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(ring[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(ring[k], v), k
    assert torch.equal(ao, ao_single)
    np.testing.assert_allclose(ring_ao.numpy(), ao_single.numpy(), atol=1e-6)
