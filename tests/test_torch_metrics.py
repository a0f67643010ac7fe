"""Render statistics and the knob probes (render/metrics.py) against the
JAX package's (mirrors tests/test_metrics_and_parity.py's metrics and
probe tests).

* `collect_render_metrics` gives JAX's dict exactly (every count, and
  the means, p99s and fractions to the last bit) on the serial scene over
  the csr grid (faithful: any t, any_pass acceptance, the walk to the
  end) and the turbo packed grid, the parallel scene, the gradcheck scene
  with ray_tile 64 (the CPU's chunks) and the reduced nefertiti scene's
  tiled packed march.
* The probes pick what JAX's pick (`choose_fused_shadow`,
  `choose_camera_refill`; `estimate_coverage` to the bit against op-by-op
  JAX: jitted XLA contracts the Cramer solve, and rays on the wall's
  diagonal edge then flip) on the serial, parallel and nefertiti scenes
  and on JAX's full-frame wall, where the tiled schedule is not fused and
  the camera refill is off.
* The refusals: an area light and spp > 1 raise NotImplementedError, as
  in JAX; the faithful serial metrics count the image's lit pixels.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu import config as jax_config  # noqa: E402
from ray_tracer_tpu.io.obj import MeshArrays as JaxMeshArrays  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import metrics as jax_metrics  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch import config  # noqa: E402
from ray_tracer_tpu_torch.io.obj import MeshArrays  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render import metrics  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402


def _rep(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _nefertiti(m, dev):
    kw = dict(n_lat=32, n_lon=64)
    if dev is None:
        return m.nefertiti_scene(24, 24, **kw)
    return m.nefertiti_scene(24, 24, device=dev, **kw)


def _gradcheck(m, dev):
    scene, cfg = m.gradcheck_scene(16, 16) if dev is None else m.gradcheck_scene(
        16, 16, device=dev)
    return scene, _rep(cfg, ray_tile=64)


def _wall(c, s, mesh_cls, dev, span=9.0, **render_kw):
    """JAX's full-frame wall quad (tests/test_metrics_and_parity.py)."""
    quad = mesh_cls(
        verts=np.array([[-span, -span, 0], [span, -span, 0], [span, span, 0],
                        [-span, span, 0]], np.float32),
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        uvs=np.zeros((1, 2), np.float32), uv_faces=np.zeros((2, 3), np.int32))
    mat = c.MaterialConfig()
    light = c.LightConfig(position=(0.0, 0.0, 5.0), intensity=1.0)
    kw = {} if dev is None else dict(device=dev)
    wall = s.scene_from_meshes([(quad, 0)], [mat], light, **kw)
    base = s.serial_scene_config(128, 128).render
    cfg = c.SceneConfig(
        materials=(mat,),
        camera=c.CameraConfig(position=(0, 0, 3), target=(0, 0, 0), up=(0, 1, 0),
                              fov_degrees=60.0, width=64, height=64),
        light=light,
        render=dataclasses.replace(base, faithful=False, det_dtype="float32",
                                   traversal="packed", **render_kw))
    return wall, cfg


def _pair(make):
    """(port prep, JAX prep) of make(config module, scenes module, device)."""
    scene, cfg = make(config, scenes, "cpu")
    jscene, jcfg = make(jax_config, jax_scenes, None)
    return (prepare(cfg, scene=scene, device="cpu" if scene is None else None),
            jax_renderer.prepare(jcfg, scene=jscene))


CASES = {
    "serial_csr_faithful": lambda c, s, d: (None, s.serial_scene_config(16, 16)),
    "serial_turbo": lambda c, s, d: (None, c.apply_turbo(s.serial_scene_config(16, 16),
                                                         "serial")),
    "parallel_csr": lambda c, s, d: (None, s.parallel_scene_config(16, 16)),
    "gradcheck_tiles": lambda c, s, d: _gradcheck(s, d),
    "nefertiti_tiled_packed": lambda c, s, d: _nefertiti(s, d),
}


@pytest.mark.parametrize("name", list(CASES))
def test_collect_render_metrics_equal_to_jax(name):
    prep, jprep = _pair(CASES[name])
    got = metrics.collect_render_metrics(prep)
    want = jax_metrics.collect_render_metrics(jprep)
    assert got == want
    assert got["primary_rays"] == prep.cfg.camera.width * prep.cfg.camera.height
    assert 0 < got["primary_hit_rate"] <= 1 and got["shadow_hits"] <= got["primary_hits"]
    assert ("packed_blocks" in got) == (prep.packed is not None)


PROBE_CASES = {
    "serial_packed_tiled": lambda c, s, d: (None, _rep(s.serial_scene_config(128, 128),
                                                       faithful=False, traversal="packed",
                                                       det_dtype="float32")),
    "serial_turbo": lambda c, s, d: (None, c.apply_turbo(s.serial_scene_config(64, 64),
                                                         "serial")),
    "parallel_csr": lambda c, s, d: (None, s.parallel_scene_config(64, 64)),
    "nefertiti_packed_tiled": lambda c, s, d: _nefertiti(s, d),
    "wall_tiled": lambda c, s, d: _wall(c, s, MeshArrays if d else JaxMeshArrays, d),
    "big_wall_persistent": lambda c, s, d: _wall(c, s, MeshArrays if d else JaxMeshArrays, d,
                                                 span=99.0, scheduler="persistent"),
}


@pytest.mark.parametrize("name", list(PROBE_CASES))
def test_probes_pick_what_jax_picks(name):
    prep, jprep = _pair(PROBE_CASES[name])
    cov = metrics.estimate_coverage(prep)
    with jax.disable_jit():  # jitted XLA contracts the Cramer solve: edge rays flip
        assert cov == jax_metrics.estimate_coverage(jprep)
    fused = metrics.choose_fused_shadow(prep)
    refill = metrics.choose_camera_refill(prep)
    assert fused is jax_metrics.choose_fused_shadow(jprep)
    assert refill is jax_metrics.choose_camera_refill(jprep)
    if name.startswith("wall"):  # the dense full frame: two-pass, gather refill
        assert cov > 0.9 and fused is False and refill is False
    if name == "serial_packed_tiled":  # spot+blub: a sparse frame, 61% dead rays
        assert fused is True and refill is True
    if name == "big_wall_persistent":  # the persistent scheduler always fuses
        assert fused is True and refill is False


@pytest.mark.parametrize("change", [dict(shadow_samples=4, light_radius=0.5, faithful=False),
                                    dict(spp=2)], ids=["area_light", "spp2"])
def test_refusals_as_jax(change):
    prep, jprep = _pair(lambda c, s, d: (None, _rep(s.serial_scene_config(8, 8), **change)))
    with pytest.raises(NotImplementedError):
        jax_metrics.collect_render_metrics(jprep)
    with pytest.raises(NotImplementedError):
        metrics.collect_render_metrics(prep)


def test_metrics_match_render_under_faithful_serial():
    """The faithful serial policy (any t, any_pass acceptance, the shadow
    walk to the end): primary_hits is the image's lit-pixel count."""
    prep = prepare(scenes.serial_scene_config(32, 32), device="cpu")
    m = metrics.collect_render_metrics(prep)
    lit = int((render(prep).numpy() > 0).any(axis=-1).sum())
    assert m["primary_hits"] == lit
    assert m["shadow_hits"] <= m["primary_hits"]
