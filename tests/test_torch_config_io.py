"""Scene config files in the port (config.save_scene_config and
load_scene_config) against the JAX package's (ray_tracer_tpu/config.py
`_to_jsonable`, `_from_dict`; mirrors tests/test_config.py).

* For the serial, parallel, turbo and path-traced configs, and one with
  extra lights, float64 rays and a lens, the port writes the JAX
  package's bytes, and each package loads the other's file into an equal
  config (field for field, tuples included).
* The round trip keeps every field; a file missing fields loads their
  defaults.
* `cli render --config` and `cli fit --config` take a file: the image is
  the one of the config rendered in process.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu import config as jax_config  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu_torch import cli  # noqa: E402
from ray_tracer_tpu_torch import config  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402


def _features(m, cfg):
    cfg = dataclasses.replace(
        cfg, extra_lights=(m.LightConfig(position=(1.0, 2.0, 3.0), intensity=0.5),),
        camera=dataclasses.replace(cfg.camera, aperture=0.25, focus_distance=20.0))
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, dtype="float64", spp=2, faithful=False, light_radius=0.5,
        shadow_samples=4))


def _gi(m, cfg):
    return m.apply_turbo(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, gi_samples=4, gi_depth=2)), "serial")


CONFIGS = {
    "serial": lambda m, s: s.serial_scene_config(64, 48),
    "parallel": lambda m, s: s.parallel_scene_config(32, 32),
    "turbo_parallel": lambda m, s: m.apply_turbo(s.parallel_scene_config(32, 32), "parallel"),
    "gi": lambda m, s: _gi(m, s.serial_scene_config(32, 32)),
    "features": lambda m, s: _features(m, s.serial_scene_config(16, 16)),
}


def _as_dict(cfg):
    return json.loads(json.dumps(config._to_jsonable(cfg)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_same_bytes_and_cross_loading(name, tmp_path):
    cfg = CONFIGS[name](config, scenes)
    jcfg = CONFIGS[name](jax_config, jax_scenes)
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "jax.json")
    config.save_scene_config(cfg, ours)
    jax_config.save_scene_config(jcfg, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    from_jax = config.load_scene_config(theirs)
    assert from_jax == cfg
    assert jax_config.load_scene_config(ours) == jcfg
    assert config.load_scene_config(ours) == cfg
    assert isinstance(from_jax.meshes, tuple) and isinstance(from_jax.camera.position, tuple)


def test_missing_fields_take_defaults(tmp_path):
    path = str(tmp_path / "partial.json")
    with open(path, "w") as fh:
        json.dump({"camera": {"width": 20}, "render": {"spp": 2, "grid": {"leap": "cheb"}}},
                  fh)
    cfg = config.load_scene_config(path)
    assert cfg.camera == config.CameraConfig(width=20)
    assert cfg.render == config.RenderConfig(spp=2, grid=config.GridConfig(leap="cheb"))
    assert cfg.meshes == () and cfg.materials == (config.MaterialConfig(),)
    assert _as_dict(cfg) == _as_dict(jax_config.load_scene_config(path))


def test_cli_render_and_fit_take_a_config(tmp_path, capsys):
    cfg = scenes.serial_scene_config(16, 16)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, dtype="float64"))
    path = str(tmp_path / "scene.json")
    jax_config.save_scene_config(CONFIGS["serial"](jax_config, jax_scenes), path)
    jcfg_file = config.load_scene_config(path)
    assert jcfg_file.camera.width == 64
    config.save_scene_config(cfg, path)
    out = str(tmp_path / "x.ppm")
    cli.main(["render", "--config", path, "--width", "8", "--out", out, "--device", "cpu"])
    want = tonemap_u8(render(prepare(cfg, device="cpu")).numpy())
    got = read_ppm(out)
    assert got.shape == (16, 16, 3)  # the file's size, not --width
    np.testing.assert_array_equal(got, want)
    gcfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, dtype="float32"))
    config.save_scene_config(gcfg, path)
    cli.main(["fit", "--config", path, "--steps", "2", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["first_loss"]) and res["last_loss"] <= res["first_loss"]
    assert os.path.exists(path)
