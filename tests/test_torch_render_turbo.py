"""The tuned production render (config.apply_turbo: packed grid,
persistent wave, fused shadow march) of the port on the CPU, against the
JAX package's render of the same config.

The serial turbo render at 32x32 is float-identical to the JAX render run
op by op (`jax.disable_jit()`).  Against jitted JAX it follows the rule of
tests/test_pallas.py:41-57: more than 2 counts apart on under 1% of
pixels (it measured 0 bytes apart at 32x32 serial and 24x24 parallel).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import (  # noqa: E402
    check_supported,
    prepare,
    render,
    whitted_wave_eligible,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32


def _image_rule(a, b):
    diff = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.01


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


@pytest.fixture(scope="module")
def serial_turbo():
    cfg = apply_turbo(scenes.serial_scene_config(SIZE, SIZE), "serial")
    prep = prepare(cfg, device="cpu")
    return cfg, prep, render(prep)


def test_turbo_serial_config_is_supported():
    """The repair: the turbo serial config sets gi_wave="auto" (no effect
    without gi_samples) and whitted_wave="off"; neither raises."""
    cfg = apply_turbo(scenes.serial_scene_config(SIZE, SIZE), "serial")
    assert cfg.render.gi_wave == "auto" and cfg.render.traversal == "packed"
    check_supported(cfg)


def test_turbo_serial_matches_op_by_op_jax(serial_turbo):
    _, _, img = serial_turbo
    jcfg = jax_apply_turbo(jax_scenes.serial_scene_config(SIZE, SIZE), "serial")
    with jax.disable_jit():
        want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg)), np.float32)
    np.testing.assert_array_equal(img.numpy().view(np.uint32), want.view(np.uint32))
    assert (tonemap_u8(want).max(axis=-1) > 0).sum() > 100


def test_turbo_serial_matches_jitted_jax(serial_turbo):
    _, _, img = serial_turbo
    jcfg = jax_apply_turbo(jax_scenes.serial_scene_config(SIZE, SIZE), "serial")
    want = tonemap_u8(np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg))))
    _image_rule(tonemap_u8(img.numpy()), want)


def test_turbo_parallel_bounces_match_jitted_jax():
    """The 3-bounce reflective scene with the turbo knobs and the bounce
    loop (whitted_wave="off"): a fused persistent march at every depth."""
    cfg = _replace(apply_turbo(scenes.parallel_scene_config(24, 24), "parallel"),
                   whitted_wave="off")
    got = tonemap_u8(render(prepare(cfg, device="cpu")).numpy())
    jcfg = jax_apply_turbo(jax_scenes.parallel_scene_config(24, 24), "parallel")
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(jcfg.render,
                                                                whitted_wave="off"))
    want = tonemap_u8(np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg))))
    _image_rule(got, want)
    assert got.any()


@pytest.mark.parametrize("change", [
    dict(wave=100), dict(pump=1), dict(queue_order="chord"), dict(grid_layout="blocks"),
    dict(scheduler="tiled"), dict(fused_shadow=False), dict(camera_refill="off"),
    dict(ray_tile=300),
], ids=lambda c: next(iter(c)))
def test_image_does_not_depend_on_schedule_or_layout(serial_turbo, change):
    """Knobs that only schedule rays, pick the grid layout or split the
    primary and shadow marches leave the image bitwise the same."""
    cfg, prep, img = serial_turbo
    c = _replace(cfg, **change)
    p = prep._replace(cfg=c) if "grid_layout" not in change else prepare(c, device="cpu")
    assert torch.equal(render(p), img)


def test_cli_turbo_writes_the_in_process_bytes(serial_turbo, tmp_path):
    _, _, img = serial_turbo
    out = tmp_path / "turbo.ppm"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "serial",
         "--width", str(SIZE), "--turbo", "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (read_ppm(str(out)) == tonemap_u8(img.numpy())).all()


def test_parallel_turbo_needs_the_whitted_wave(monkeypatch, tmp_path):
    """TUNED_KNOBS["parallel"] opts into the cross-depth Whitted wave:
    `render` and the command line of the 8x8 turbo parallel scene go
    through it (kernel E's plain version on the CPU), with the same
    bytes."""
    from ray_tracer_tpu_torch import cli
    from ray_tracer_tpu_torch.ops import whitted_wave

    cfg = apply_turbo(scenes.parallel_scene_config(8, 8), "parallel")
    assert whitted_wave_eligible(cfg)
    check_supported(cfg)
    calls = []
    plain = whitted_wave.whitted_wave_plain

    def spy(rays, *args, **kw):
        calls.append(rays.count)
        return plain(rays, *args, **kw)

    monkeypatch.setattr(whitted_wave, "whitted_wave_plain", spy)
    img = render(prepare(cfg, device="cpu"))
    assert calls == [64] and img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    out = tmp_path / "parallel.ppm"
    cli.main(["render", "--scene", "parallel", "--width", "8", "--turbo",
              "--device", "cpu", "--out", str(out)])
    assert calls == [64, 64]
    assert (read_ppm(str(out)) == tonemap_u8(img.numpy())).all()


def test_whitted_wave_knob_follows_jax():
    """"on" with an ineligible config raises ValueError as the JAX render
    does; "auto" with one renders through the bounce loop; a path-traced
    config never takes the Whitted wave, even with "on" (the JAX render
    sends gi_samples > 0 to the path tracer before the knob is read)."""
    base = scenes.parallel_scene_config(8, 8)
    with pytest.raises(ValueError, match="ineligible"):
        check_supported(_replace(base, whitted_wave="on"))
    tiled = _replace(apply_turbo(base, "parallel"), scheduler="tiled")
    assert tiled.render.whitted_wave == "auto" and not whitted_wave_eligible(tiled)
    img = render(prepare(tiled, device="cpu"))
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    gi = _replace(apply_turbo(base, "parallel"), gi_samples=1, whitted_wave="on")
    assert check_supported(gi) is False
    assert check_supported(_replace(gi, texture="checker")) is False
    with pytest.raises(NotImplementedError, match="extra lights"):
        check_supported(dataclasses.replace(gi, extra_lights=(gi.light,)))
