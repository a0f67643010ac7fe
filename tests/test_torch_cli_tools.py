"""The port's inspection commands in process on the CPU at 16x16
(mirrors tests/test_cli.py's stats, debug, aov, info and bench tests).

* `stats` prints JAX's `stats` JSON for the same scene and options, and
  with --turbo JAX's metrics of the tuned config.
* `debug` prints the port's trace_pixel for the pixel, with the JAX
  command's keys.
* `aov` writes JAX's buffers (the same names and shapes; hit, tri_id and
  material_id equal to the JAX command's file), and `--ao-samples` the
  port's render_ao.
* `info` prints the JAX command's keys: the devices, process count 1,
  whether the kernels are built and the default device.
* `bench` execs bench_torch.py with its options; `--ring` is refused
  (the ring slice); `aov --devices 2` and `render --devices 2` on two CPU
  ranks write the single-device output, and `debug --devices 2` traces
  on one device.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu import cli as jax_cli  # noqa: E402
from ray_tracer_tpu_torch import cli  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render.aov import render_ao  # noqa: E402
from ray_tracer_tpu_torch.render.debug import trace_pixel  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare  # noqa: E402

SCENE = ["--scene", "gradcheck", "--width", "16", "--fast"]


def _fast_gradcheck():
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    return scene, dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                      faithful=False))


def _json_out(capsys):
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--fast"]], ids=["faithful", "fast"])
def test_stats_command_equals_jax(capsys, extra):
    args = ["stats", "--scene", "serial", "--width", "16", *extra]
    cli.main(args + ["--device", "cpu"])
    ours = _json_out(capsys)
    jax_cli.main(args)
    assert ours == _json_out(capsys)
    assert ours["primary_rays"] == 256


def test_stats_turbo_is_the_tuned_config(capsys):
    """--turbo (the port's inspection commands take it, as render does):
    JAX's metrics of apply_turbo's config."""
    from ray_tracer_tpu.config import apply_turbo
    from ray_tracer_tpu.models.scenes import serial_scene_config
    from ray_tracer_tpu.render.metrics import collect_render_metrics
    from ray_tracer_tpu.render.renderer import prepare as jax_prepare

    cli.main(["stats", "--scene", "serial", "--width", "16", "--turbo", "--device", "cpu"])
    ours = _json_out(capsys)
    want = collect_render_metrics(jax_prepare(apply_turbo(serial_scene_config(16, 16),
                                                          "serial")))
    assert ours == json.loads(json.dumps(want)) and "packed_blocks" in ours


def test_debug_command(capsys):
    cli.main(["debug", *SCENE, "--x", "8", "--y", "12", "--device", "cpu"])
    ours = _json_out(capsys)
    jax_cli.main(["debug", *SCENE, "--x", "8", "--y", "12"])
    theirs = _json_out(capsys)
    assert ours["pixel"] == [8, 12] and set(ours) == set(theirs)
    assert ours["hit"] == theirs["hit"] and ours["tri_id"] == theirs["tri_id"]
    scene, cfg = _fast_gradcheck()
    want = json.loads(json.dumps(trace_pixel(prepare(cfg, scene=scene), 8, 12)))
    assert ours == want


def test_aov_command(tmp_path):
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "jax.npz")
    cli.main(["aov", *SCENE, "--ao-samples", "4", "--out", ours, "--device", "cpu"])
    jax_cli.main(["aov", *SCENE, "--ao-samples", "4", "--out", theirs])
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    for k in ("hit", "tri_id", "material_id"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    scene, cfg = _fast_gradcheck()
    np.testing.assert_array_equal(a["ao"], render_ao(prepare(cfg, scene=scene), samples=4)
                                  .numpy())


def test_info_command(capsys):
    cli.main(["info"])
    ours = _json_out(capsys)
    jax_cli.main(["info"])
    theirs = _json_out(capsys)
    assert set(theirs) <= set(ours)
    assert ours["process_count"] == 1
    assert ours["default_backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert ours["devices"] and isinstance(ours["native_library"], bool)
    assert set(ours["kernels_built"]) == {"brute_intersect", "traverse_grid", "packed_march",
                                          "gather_row_test", "whitted_wave", "gi_wave",
                                          "empty_boxes", "grid_bin", "take_grad"}


def test_bench_command_execs_bench_torch(monkeypatch):
    seen = {}

    def fake_execv(path, argv):
        seen["argv"] = argv
        raise SystemExit(0)

    monkeypatch.setattr(os, "execv", fake_execv)
    with pytest.raises(SystemExit):
        cli.main(["bench", "--rows", "spot_1024", "--rounds", "2"])
    argv = seen["argv"]
    assert argv[0] == sys.executable and argv[1].endswith("bench_torch.py")
    assert os.path.exists(argv[1])
    assert argv[2:] == ["--rows", "spot_1024", "--rounds", "2"]


@pytest.mark.parametrize("cmd", [["debug", "--x", "1", "--y", "1"], ["aov"]])
@pytest.mark.parametrize("flag", [["--devices", "2"], ["--ring"], ["--devices", "2", "--ring"]])
def test_multi_device_flags_refused(cmd, flag, tmp_path, capfd):
    """The multi-device flags are served: `aov --devices 2` on two CPU ranks
    writes the single-device file's arrays, and `debug --devices 2` traces
    its pixel on one device, as the JAX command without --ring; --ring
    alone is the single-device command (the JAX command's rule); with
    --devices 2 --ring the geometry is sharded over two ranks ((1, 2)
    ("rays", "tris")), every trace a ring orbit: ids and flags the
    single-device ones, floats to 1e-5, and debug's steps -1."""
    def run(extra, name):
        out = ["--out", str(tmp_path / name)] if cmd == ["aov"] else []
        cli.main([cmd[0], *SCENE, *cmd[1:], *extra, *out, "--device", "cpu"])
        # capfd: rank 0 of the spawned ranks prints through the inherited fd
        return np.load(tmp_path / name) if cmd == ["aov"] else _json_out(capfd)

    got, want = run(flag, "d2.npz"), run([], "d0.npz")
    ring = flag == ["--devices", "2", "--ring"]
    if cmd == ["aov"]:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            if ring and want[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(got[k], want[k])
    elif ring:
        assert got["steps"] == -1 and got["tri_id"] == want["tri_id"]
        for k, v in want.items():
            if k != "steps":
                np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(v, float),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        assert got == want


def test_render_devices_writes_the_single_device_ppm(tmp_path):
    """`render --devices 2 --device cpu` (two gloo ranks the command starts,
    rank 0 writing) gives `render`'s PPM bytes (tests/test_cli.py:34)."""
    for name, extra in (("d2.ppm", ["--devices", "2"]), ("d0.ppm", [])):
        cli.main(["render", "--scene", "serial", "--width", "16", "--turbo", *extra,
                  "--out", str(tmp_path / name), "--device", "cpu"])
    assert (tmp_path / "d2.ppm").read_bytes() == (tmp_path / "d0.ppm").read_bytes()
    # --ring: the geometry sharded over the two ranks (tests/test_torch_ring.py
    # holds the bytes against render_sharded_geometry); this scene's ring
    # image rounds to render()'s bytes
    cli.main(["render", "--scene", "serial", "--width", "16", "--turbo", "--devices", "2",
              "--ring", "--out", str(tmp_path / "r.ppm"), "--device", "cpu"])
    assert (tmp_path / "r.ppm").read_bytes() == (tmp_path / "d0.ppm").read_bytes()
    with pytest.raises(SystemExit, match="cuda ranks"):
        cli.main(["render", "--scene", "serial", "--width", "16", "--devices", "2",
                  "--out", str(tmp_path / "c.ppm")])
