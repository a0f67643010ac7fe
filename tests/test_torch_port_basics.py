"""The PyTorch port's package boundary: independence from JAX, device
rules, unsupported options and the kernel build's failure mode."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_INDEPENDENCE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["ray_tracer_tpu"] = None
import torch
torch.set_num_threads(1)
import ray_tracer_tpu_torch
for m in pkgutil.walk_packages(ray_tracer_tpu_torch.__path__, "ray_tracer_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke  # the card check imports nothing of JAX either
from ray_tracer_tpu_torch.models.scenes import serial_scene_config
from ray_tracer_tpu_torch.config import apply_turbo
from ray_tracer_tpu_torch.render.renderer import prepare, render
img = render(prepare(serial_scene_config(8, 8), device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
img = render(prepare(apply_turbo(serial_scene_config(8, 8), "serial"), device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
from ray_tracer_tpu_torch.models.scenes import parallel_scene_config
img = render(prepare(apply_turbo(parallel_scene_config(8, 8), "parallel"), device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
import ray_tracer_tpu_torch.ops.persistent, ray_tracer_tpu_torch.tools.gather_bench
import ray_tracer_tpu_torch.ops.whitted_wave, ray_tracer_tpu_torch.ops.gi_wave
import ray_tracer_tpu_torch.render.pathtrace
import bench_torch  # the port's bench imports nothing of JAX either
import dataclasses
gi = apply_turbo(dataclasses.replace(serial_scene_config(8, 8), render=dataclasses.replace(
    serial_scene_config(8, 8).render, gi_samples=2, gi_depth=1)), "serial")
img = render(prepare(gi, device="cpu"))  # the GI wave's plain version
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
off = dataclasses.replace(gi, render=dataclasses.replace(gi.render, gi_wave="off"))
img = render(prepare(off, device="cpu"))  # the segment integrator
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
from ray_tracer_tpu_torch.models.scenes import build_scene
app = dataclasses.replace(gi, render=dataclasses.replace(gi.render, normal_mode="smooth",
                                                         texture="image"))
sc = build_scene(app, device="cpu")._replace(texture_image=torch.rand(4, 4, 3),
                                             env_image=torch.full((4, 8, 3), 30.0))
img = render(prepare(app, scene=sc))  # the GI wave with every appearance feature
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
wapp = apply_turbo(dataclasses.replace(serial_scene_config(8, 8), render=dataclasses.replace(
    serial_scene_config(8, 8).render, normal_mode="smooth", texture="image")), "serial")
img = render(prepare(wapp, scene=sc))  # the bounce loop with them
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
scene, ncfg = nefertiti_scene(8, 8, n_lat=8, n_lon=16, device="cpu")
img = render(prepare(apply_turbo(ncfg, "nefertiti"), scene=scene))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
from ray_tracer_tpu_torch.models.scenes import gradcheck_scene
from ray_tracer_tpu_torch.opt.checkpoint import latest_step, save_checkpoint
from ray_tracer_tpu_torch.opt.fit import fit, merge_scene, split_scene
import tempfile
gscene, gcfg = gradcheck_scene(8, 8, device="cpu")
gcfg = dataclasses.replace(gcfg, render=dataclasses.replace(gcfg.render, soft_visibility=0.1,
                                                            soft_primary=0.05))
gprep = prepare(gcfg, scene=gscene)
p = split_scene(gprep.scene)
with tempfile.TemporaryDirectory() as d:  # the fit loop and its checkpoints
    _, losses = fit(gprep._replace(scene=merge_scene(p._replace(kd=p.kd * 1.5), gprep.scene)),
                    render(gprep), steps=2, lr=5e-2, trainable=("kd", "verts"),
                    rebuild_grid_every=1, checkpoint_dir=d, checkpoint_every=1, log_every=0)
    assert len(losses) == 2 and latest_step(d) == 2
import torch.distributed as dist
from ray_tracer_tpu_torch import render_sharded as root_render_sharded
from ray_tracer_tpu_torch.parallel import make_mesh, render_sharded
from ray_tracer_tpu_torch.parallel import collectives, multihost, scaling, shard
assert root_render_sharded is render_sharded
mesh = make_mesh(devices="cpu")  # a one-rank gloo group, the multi-device layer at world 1
wprep = prepare(apply_turbo(parallel_scene_config(8, 8), "parallel"), device="cpu")
assert torch.equal(render_sharded(wprep, mesh=mesh), render(wprep))
dist.destroy_process_group()
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k.split(".")[0] in ("jax", "jaxlib", "ray_tracer_tpu"))]
assert not loaded, loaded
print("independent")
"""


def test_port_imports_nothing_of_jax():
    """Every module of the port (the packed grid, the packed march, the
    persistent wave, the Whitted and GI waves, the path tracer and the
    gather tool among them), chip_smoke.py and bench_torch.py import, and
    the port renders 8x8 images (serial default and turbo, the turbo
    parallel scene through the Whitted wave, path-traced GI through the GI
    wave and the segment integrator, the GI wave and the bounce loop with
    every appearance feature, and a small nefertiti scene), and a fit of
    two steps with soft visibility, soft primary, a grid rebuild and
    checkpoints (opt.fit, opt.checkpoint) runs, and the multi-device layer
    (parallel/: mesh, multihost, collectives, shard, scaling) renders the
    Whitted wave sharded on a one-rank group as render() does, with `jax`
    and `ray_tracer_tpu` made unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _INDEPENDENCE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "independent" in out.stdout


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """Without a CUDA device, prepare/render/camera/scene entry points
    raise instead of falling back to the CPU."""
    from ray_tracer_tpu_torch.models.scenes import build_scene, serial_scene_config
    from ray_tracer_tpu_torch.ops.camera import camera_rays
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = serial_scene_config(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        camera_rays(cfg.camera)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_scene(cfg)
    prep = prepare(cfg, device="cpu")  # the explicit request works
    assert render(prep).device.type == "cpu"


@pytest.mark.parametrize("change", [
    dict(traversal="packed", faithful=False, dtype="float64"),
    dict(dtype="float64"),
    dict(extra_lights=True),
    dict(shadow_samples=4, light_radius=0.5, traversal="packed", faithful=False),
    dict(light_radius=0.5, faithful=False),
    dict(shadow_samples=4, light_radius=0.5, faithful=False),
    dict(gi_samples=1, faithful=False, gi_env_nee=True),
    dict(gi_samples=1, faithful=False, transmissive=True),
    dict(extra_lights=True, traversal="packed", scheduler="persistent", faithful=False),
])
def test_unsupported_options_raise(change):
    """Every option of this table was refused before the port served it
    (dtype="float64", area-light soft shadows, extra lights and, in the
    path tracer, env NEE and glass): each now prepares and renders (a
    float64 image for dtype="float64"), and a dtype the port does not
    serve still raises NotImplementedError."""
    from ray_tracer_tpu_torch.config import LightConfig, MaterialConfig
    from ray_tracer_tpu_torch.models.scenes import serial_scene_config
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    cfg = serial_scene_config(8, 8)
    change = dict(change)
    if change.pop("extra_lights", False):
        cfg = dataclasses.replace(cfg, extra_lights=(LightConfig((1.0, 2.0, 3.0), 1.0),))
    if change.pop("transmissive", False):
        cfg = dataclasses.replace(cfg, materials=(MaterialConfig(transmissive=True, ior=1.5),))
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **change))
    img = render(prepare(cfg, device="cpu"))
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    if cfg.render.dtype == "float64":
        assert img.dtype == torch.float64
        with pytest.raises(NotImplementedError, match="dtype"):
            prepare(dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, dtype="float16")), device="cpu")


@pytest.mark.parametrize("change", [
    dict(traversal="packed", scheduler="persistent", faithful=False, soft_visibility=0.1),
    dict(soft_primary=0.1, faithful=False),
    dict(soft_visibility=0.1),
])
def test_soft_options_render(change):
    """Soft visibility and soft primary, refused before the port served
    them, render finite 8x8 images that keep to jitted JAX's by the 2-count
    rule, and never through the Whitted wave."""
    import numpy as np

    from ray_tracer_tpu.models import scenes as jax_scenes
    from ray_tracer_tpu.render import renderer as jax_renderer
    from ray_tracer_tpu_torch.io.ppm import tonemap_u8
    from ray_tracer_tpu_torch.models.scenes import serial_scene_config
    from ray_tracer_tpu_torch.render.renderer import prepare, render, whitted_wave_eligible

    cfg = serial_scene_config(8, 8)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, whitted_wave="auto",
                                                              **change))
    jcfg = jax_scenes.serial_scene_config(8, 8)
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(jcfg.render, **change))
    assert not whitted_wave_eligible(cfg)
    img = render(prepare(cfg, device="cpu")).numpy()
    want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg)))
    a, b = tonemap_u8(img).astype(int), tonemap_u8(want).astype(int)
    assert np.isfinite(img).all() and img.max() > 0
    assert (np.abs(a - b).max(axis=-1) > 2).mean() < 0.01


@pytest.mark.parametrize("change", [
    dict(texture="checker"),
    dict(normal_mode="smooth", faithful=False),
    dict(gi_samples=1, faithful=False, texture="checker", background=(40.0, 30.0, 20.0)),
])
def test_appearance_options_render(change):
    """Textures and smooth normals, refused before the port served them,
    render: the 8x8 serial image equals its bytes under the JAX package's
    jitted render within the 2-count rule (under 1% of pixels more than 2
    counts apart; the path-traced case against op-by-op JAX)."""
    import jax
    import numpy as np

    from ray_tracer_tpu.models import scenes as jax_scenes
    from ray_tracer_tpu.render import renderer as jax_renderer
    from ray_tracer_tpu_torch.io.ppm import tonemap_u8
    from ray_tracer_tpu_torch.models.scenes import serial_scene_config
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    cfg = serial_scene_config(8, 8)
    jcfg = jax_scenes.serial_scene_config(8, 8)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **change))
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(jcfg.render, **change))
    img = render(prepare(cfg, device="cpu")).numpy()
    if cfg.render.gi_samples:
        with jax.disable_jit():
            want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg)))
    else:
        want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg)))
    a, b = tonemap_u8(img).astype(int), tonemap_u8(want).astype(int)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0
    assert (np.abs(a - b).max(axis=-1) > 2).mean() < 0.01


def test_kernel_wrappers_take_cuda_tensors_only():
    """The CUDA wrappers refuse CPU tensors; the dispatchers take the plain
    version only because the tensors lie on the CPU."""
    from ray_tracer_tpu_torch.ops import brute_intersect as bi

    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    tri9 = torch.zeros((9, 2))
    with pytest.raises(ValueError, match="CUDA"):
        bi.brute_intersect_cuda(o, d, tri9, 0.0)
    before = bi.brute_intersect_cuda.launches
    t, tid = bi.brute_intersect(o, d, tri9, 0.0)
    assert bi.brute_intersect_cuda.launches == before
    assert torch.isinf(t).all() and (tid == -1).all()


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's output; there is no
    fallback to the plain versions."""
    from ray_tracer_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("NVCC", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="nvcc failed for brute_intersect.cu"):
        _build.build(["brute_intersect"])
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())


def test_every_kernel_is_built_by_default():
    """build() with no names compiles all eight sources, each into its own
    library keyed by its sources and flags (the shared headers included:
    packed_step.cuh serves kernels C, E and F)."""
    from ray_tracer_tpu_torch.kernels import _build

    assert _build.KERNELS == ("brute_intersect", "traverse_grid", "packed_march",
                              "gather_row_test", "whitted_wave", "gi_wave", "empty_boxes",
                              "grid_bin")
    for name in _build.KERNELS:
        assert os.path.exists(os.path.join(_build.CSRC, name + ".cu"))
    paths = {_build.library_path(n) for n in _build.KERNELS}
    assert len(paths) == len(_build.KERNELS)


@pytest.mark.parametrize("name", ["packed_march", "gather_row_test", "whitted_wave",
                                  "gi_wave", "empty_boxes", "grid_bin"])
def test_failed_build_of_new_kernels_raises(monkeypatch, tmp_path, name):
    from ray_tracer_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("NVCC", "false")
    with pytest.raises(RuntimeError, match=f"nvcc failed for {name}.cu"):
        _build.build([name])
