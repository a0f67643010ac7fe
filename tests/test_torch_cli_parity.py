"""The port's command line and package root against the JAX package's, on
the CPU at 8x8 to 16x16.

* Every option of every JAX subcommand is an option of the port's, with
  the same destination, kind and default, and JAX's choices among the
  port's (both parsers taken from their `main` just before it parses).
* `render --scene gradcheck` writes the JAX command's PPM bytes and
  render()'s; on the card `prepare` takes the scene the command built on
  cuda:0 for device "cuda".
* `--gi` is `--gi-samples` (one destination, the same bytes).
* `--gi-no-specular` on the parallel scene, through the GI wave (--turbo)
  and the segment integrator: held to the JAX command's PPM by the JAX
  package's statistical rule for GI (more than 97% of pixels within 2
  counts, the means within 2%) and different from the specular image;
  the wave's render()'s bytes for gi_specular=False, without its mirror
  mix.
* `--profile DIR` writes a trace file and says so on stderr.
* `bench --width N` execs bench_torch.py --size N.
* The package root gives every name of `ray_tracer_tpu.__all__` (the
  port's own), and importing it loads neither torch nor a kernel;
  `ray_tracer_tpu_torch.opt` gives `ray_tracer_tpu.opt.__all__`.
* `models.scenes.parallel_scene` gives JAX's scene arrays (floats bitwise,
  the indices equal; the port's are int64), and `core.rays.concatenate`
  JAX's rays bitwise.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import ray_tracer_tpu  # noqa: E402
import ray_tracer_tpu_torch  # noqa: E402
from ray_tracer_tpu import cli as jax_cli  # noqa: E402
from ray_tracer_tpu import opt as jax_opt  # noqa: E402
from ray_tracer_tpu.core import rays as jax_rays  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu_torch import cli, opt  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.core import rays  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GI_LIGHT = "5000"  # the parallel scene's light (intensity 1) is black under GI's units


class _Parsed(Exception):
    pass


def _parser(main, monkeypatch):
    """The top-level parser `main` builds, taken as it starts to parse."""
    seen = {}

    def stop(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        main(["info"])
    monkeypatch.undo()
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def test_no_jax_option_is_missing_from_the_port(monkeypatch):
    theirs, ours = _parser(jax_cli.main, monkeypatch), _parser(cli.main, monkeypatch)
    missing = []
    for cmd, jp in theirs.items():
        assert cmd in ours, cmd
        for opt_string, ja in jp._option_string_actions.items():
            pa = ours[cmd]._option_string_actions.get(opt_string)
            if pa is None:
                missing.append(f"{cmd} {opt_string}")
                continue
            where = f"{cmd} {opt_string}"
            assert (pa.dest, type(pa), pa.type, pa.default) == (
                ja.dest, type(ja), ja.type, ja.default), where
            assert set(ja.choices or ()) <= set(pa.choices or ()), where
    assert not missing, missing


def _ppm(tmp_path, main, name, args):
    out = str(tmp_path / f"{name}.ppm")
    main(["render", *args, "--out", out])
    return read_ppm(out)


def test_render_gradcheck_is_jax_bytes_and_render(tmp_path):
    args = ["--scene", "gradcheck", "--width", "16"]
    ours = _ppm(tmp_path, cli.main, "port", args + ["--device", "cpu"])
    np.testing.assert_array_equal(ours, _ppm(tmp_path, jax_cli.main, "jax", args))
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    np.testing.assert_array_equal(ours, tonemap_u8(render(prepare(cfg, scene=scene)).numpy()))


def test_a_scene_on_cuda_0_is_on_cuda(monkeypatch):
    """`render --scene gradcheck` (and nefertiti) builds its scene on the
    card (cuda:0) and prepares it with device="cuda": prepare's check
    takes an unindexed cuda device as the current card (the port's
    command raised here on the card before)."""
    from ray_tracer_tpu_torch.device import same_device

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    dev = torch.device
    assert same_device(dev("cuda", 0), dev("cuda")) and same_device(dev("cuda"), dev("cuda:0"))
    assert not same_device(dev("cuda", 1), dev("cuda"))
    assert not same_device(dev("cpu"), dev("cuda")) and same_device(dev("cpu"), dev("cpu"))


def test_gi_is_an_alias_of_gi_samples(tmp_path):
    base = ["--scene", "parallel", "--width", "8", "--turbo", "--gi-depth", "1",
            "--light-intensity", GI_LIGHT, "--device", "cpu"]
    a = _ppm(tmp_path, cli.main, "gi", base + ["--gi", "2"])
    b = _ppm(tmp_path, cli.main, "gi_samples", base + ["--gi-samples", "2"])
    np.testing.assert_array_equal(a, b)
    assert a.any()


def _wave_config(S: int, D: int):
    """The config `render --scene parallel --turbo --gi-samples S --gi-depth
    D --light-intensity GI_LIGHT --gi-no-specular` builds."""
    cfg = scenes.parallel_scene_config(16, 16)
    cfg = apply_turbo(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, gi_samples=S)), "parallel")
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, faithful=False, gi_samples=S, gi_depth=D, gi_specular=False))
    return dataclasses.replace(cfg, light=dataclasses.replace(cfg.light,
                                                              intensity=float(GI_LIGHT)))


@pytest.mark.parametrize("turbo,S,D", [(True, 4, 2), (False, 2, 1)],
                         ids=["gi_wave", "segments"])
def test_gi_no_specular_against_jax(tmp_path, turbo, S, D):
    args = ["--scene", "parallel", "--width", "16", "--gi-samples", str(S), "--gi-depth",
            str(D), "--light-intensity", GI_LIGHT] + (["--turbo"] if turbo else [])
    ours = _ppm(tmp_path, cli.main, "lambert", args + ["--gi-no-specular", "--device", "cpu"])
    spec = _ppm(tmp_path, cli.main, "spec", args + ["--device", "cpu"])
    theirs = _ppm(tmp_path, jax_cli.main, "jax", args + ["--gi-no-specular"])
    close = np.abs(ours.astype(int) - theirs.astype(int)).max(axis=-1) <= 2
    assert close.mean() > 0.97, close.mean()
    np.testing.assert_allclose(ours.mean(), theirs.mean(), rtol=0.02)
    assert (ours != spec).mean() > 0.05
    if turbo:  # the wave without its mirror mix (the segment loop takes ~5 s a render)
        prep = prepare(_wave_config(S, D), device="cpu")
        assert prep.setup.gi_wave and not prep.setup.gi_spec
        np.testing.assert_array_equal(ours, tonemap_u8(render(prep).numpy()))


def test_profile_writes_a_trace(tmp_path, capfd):
    logdir = str(tmp_path / "trace")
    _ppm(tmp_path, cli.main, "g", ["--scene", "gradcheck", "--width", "8", "--device", "cpu",
                                   "--profile", logdir])
    assert f"profiler trace written to {logdir}" in capfd.readouterr().err
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as fh:
        assert json.load(fh)["traceEvents"]


@pytest.mark.parametrize("args,want", [
    (["--width", "1024"], ["--size", "1024"]),
    (["--width", "64", "--repeat", "2"], ["--size", "64", "--repeat", "2"]),
])
def test_bench_width_execs_bench_torch_size(monkeypatch, args, want):
    seen = {}

    def fake_execv(path, argv):
        seen["argv"] = argv
        raise SystemExit(0)

    monkeypatch.setattr(os, "execv", fake_execv)
    with pytest.raises(SystemExit):
        cli.main(["bench", *args])
    assert seen["argv"][1] == os.path.join(REPO, "bench_torch.py")
    assert seen["argv"][2:] == want


@pytest.mark.parametrize("name", ray_tracer_tpu.__all__)
def test_root_exports_the_jax_names(name):
    value = getattr(ray_tracer_tpu_torch, name)
    if name not in ("__version__", "config", "render"):
        assert value.__module__.startswith("ray_tracer_tpu_torch."), value.__module__
    assert set(ray_tracer_tpu_torch.__all__) == set(ray_tracer_tpu.__all__)


def test_root_render_renders_after_prepare():
    """`render` at the root is the render subpackage, which the import of
    `prepare` binds there, and calling it renders."""
    rt = ray_tracer_tpu_torch
    prep = rt.prepare(rt.serial_scene_config(8, 8), device="cpu")
    assert torch.equal(rt.render(prep), render(prep))


def test_root_import_builds_nothing():
    code = ("import sys\n"
            "import ray_tracer_tpu_torch as rt\n"
            "assert rt.config.RenderConfig is rt.RenderConfig\n"
            "loaded = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax') or "
            "m.startswith('ray_tracer_tpu_torch.kernels')]\n"
            "assert not loaded, loaded\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]


def test_opt_exports_the_jax_names():
    assert opt.__all__ == jax_opt.__all__
    for name in jax_opt.__all__:
        assert getattr(opt, name).__module__ == "ray_tracer_tpu_torch.opt.fit", name


def _assert_tree_equal(ours, theirs, where):
    if theirs is None:
        assert ours is None, where
    elif hasattr(theirs, "_fields"):
        assert set(ours._fields) == set(theirs._fields), where
        for f in theirs._fields:
            _assert_tree_equal(getattr(ours, f), getattr(theirs, f), f"{where}.{f}")
    else:
        a, b = np.atleast_1d(np.asarray(ours)), np.atleast_1d(np.asarray(theirs))
        assert a.shape == b.shape, where
        if b.dtype.kind == "f":  # floats bitwise; the port's indices are int64
            assert a.dtype == b.dtype, where
            a, b = a.view(np.uint8), b.view(np.uint8)
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_parallel_scene_equals_jax():
    (ours, cfg), (theirs, jcfg) = (scenes.parallel_scene(16, 12, device="cpu"),
                                   jax_scenes.parallel_scene(16, 12))
    assert (cfg.camera.width, cfg.camera.height) == (16, 12)
    assert json.dumps(dataclasses.asdict(cfg)) == json.dumps(dataclasses.asdict(jcfg))
    _assert_tree_equal(ours, theirs, "scene")


def test_concatenate_equals_jax():
    rng = np.random.default_rng(17)
    sizes = (2, 5, 3)
    arrays = [[rng.standard_normal((n, 3)).astype(np.float32),
               rng.standard_normal((n, 3)).astype(np.float32),
               rng.random(n).astype(np.float32), (rng.random(n) * 50).astype(np.float32)]
              for n in sizes]
    ours = rays.concatenate([rays.RayBatch(*map(torch.from_numpy, a)) for a in arrays])
    theirs = jax_rays.concatenate([jax_rays.RayBatch(*map(jnp.asarray, a)) for a in arrays])
    assert isinstance(ours, rays.RayBatch) and ours.count == sum(sizes)
    _assert_tree_equal(ours, theirs, "rays")
