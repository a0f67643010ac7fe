"""The port's cross-depth GI wave (ops/gi_wave.py, kernel F's plain
version on the CPU) against the JAX package's `gi_wave_trace`.

* Against JAX run op by op (`jax.disable_jit()`), whose wave of 256 lanes
  holds every pixel of a 16x16 frame, at (S, D, pump) = (1, 1, 1),
  (3, 2, 2) and (4, 0, 4): bitwise on the escape-only plane (radiance
  there does not depend on the sampled directions) and at D = 0; with
  bounces on the gradcheck scene more than 99% of pixels bitwise, since
  only the cos/sin of a sampled angle may differ in its last bit
  (render/pathtrace.py), and the means within 0.5%.
* The mirror furnace: a perfect mirror (km = 1) under a constant
  background returns the background exactly, bitwise JAX's; km = 0.7 is
  bitwise JAX's too.
* The turbo parallel scene (the mirror mix): bitwise op-by-op JAX's, and
  against jitted JAX, whose Cramer contraction flips some bounces, more
  than 85% of pixels within 1e-5 relative and the means within 10%
  (measured 91% and 5.2%).
* The JAX wave's image does not depend on (wave, pump); the port's does
  not depend on the order of the pixels, colors and counters both.
* The port's wave against the port's segment loop: the JAX package's
  statistical rule (tests/test_pathtrace.py:565-586).
* `build_gi_wave_tables` and `build_gi_wave_tri9` equal JAX's.
* Kernel F's host side (the kernel itself runs on the card only): its
  scratch layout and stage launch values, its parameter struct and C
  signature against the ctypes mirrors, and its refusal of CPU tensors.
"""

import ctypes
import dataclasses
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import CameraConfig as JaxCameraConfig  # noqa: E402
from ray_tracer_tpu.config import LightConfig as JaxLightConfig  # noqa: E402
from ray_tracer_tpu.config import MaterialConfig as JaxMaterialConfig  # noqa: E402
from ray_tracer_tpu.config import SceneConfig as JaxSceneConfig  # noqa: E402
from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import meshes as jax_meshes  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import pathtrace as jax_pt  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import (  # noqa: E402
    CameraConfig,
    LightConfig,
    MaterialConfig,
    SceneConfig,
    apply_turbo,
)
from ray_tracer_tpu_torch.core import vecmath as vm  # noqa: E402
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.models import meshes, scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import gi_wave  # noqa: E402
from ray_tracer_tpu_torch.ops.camera import camera_rays  # noqa: E402
from ray_tracer_tpu_torch.render import pathtrace as pt  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

SIZE = 16
E = 100.0  # the furnace's constant background
GI_LIGHT = 40.0  # the gradcheck scene's light, bright enough for GI
WAVE_KW = dict(faithful=False, det_dtype="float32", traversal="packed",
               scheduler="persistent", wave=256, gi_wave="on")


def _bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _plane_pair(S, D, pump, base_color=(140.0, 90.0, 200.0), bg=(30.0, 20.0, 10.0),
                intensity=60.0, **mat_kw):
    """A lone plane under a point light: every bounce escapes upward to the
    background (tests/test_pathtrace.py's escape-only plane and, with a
    reflective material and the background E, its mirror furnace)."""
    out = []
    for mg, Mat, Light, Cam, Scn, sfm, prep, extra in (
            (jax_meshes, JaxMaterialConfig, JaxLightConfig, JaxCameraConfig, JaxSceneConfig,
             jax_scenes.scene_from_meshes, jax_renderer.prepare, {}),
            (meshes, MaterialConfig, LightConfig, CameraConfig, SceneConfig,
             scenes.scene_from_meshes, prepare, dict(device="cpu"))):
        mats = (Mat(base_color=base_color, **mat_kw),)
        light = Light(position=(0.5, 6.0, 0.3), intensity=intensity)
        scene = sfm([(mg.make_plane(extent=8.0, y=-1.0, density=2), 0)], mats, light, **extra)
        cfg = Scn(materials=mats, light=light,
                  camera=Cam(position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=SIZE,
                             height=SIZE))
        cfg = _replace(cfg, pump=pump, gi_samples=S, gi_depth=D, background=bg, **WAVE_KW)
        out.append(prep(cfg, scene=scene))
    return out


def _gradcheck_pair(S, D, pump, size=SIZE, mirror=False):
    jscene, jcfg = jax_scenes.gradcheck_scene(size, size)
    scene, cfg = scenes.gradcheck_scene(size, size, device="cpu")
    jscene = jscene._replace(light_intensity=jnp.float32(GI_LIGHT))
    scene = scene._replace(light_intensity=torch.tensor(GI_LIGHT))
    if mirror:
        jscene = jscene._replace(materials=jscene.materials._replace(
            reflective=jnp.asarray([False, True]), km=jnp.asarray([0.0, 0.6], jnp.float32)))
        scene = scene._replace(materials=scene.materials._replace(
            reflective=torch.tensor([False, True]), km=torch.tensor([0.0, 0.6])))
    kw = dict(pump=pump, gi_samples=S, gi_depth=D, **WAVE_KW)
    return (jax_renderer.prepare(_replace(jcfg, **kw), scene=jscene),
            prepare(_replace(cfg, **kw), scene=scene))


def _jax_wave_eager(jprep):
    assert jax_pt.gi_wave_eligible(jprep)
    with jax.disable_jit():
        return np.asarray(jax_pt._render_pt_wave(jprep), np.float32)


def _port_wave(prep):
    assert prep.setup.gi_wave
    return render(prep).numpy()


SDP = [(1, 1, 1), (3, 2, 2), (4, 0, 4)]


@pytest.mark.parametrize("S,D,pump", SDP)
def test_escape_plane_bitwise_vs_op_by_op_jax(S, D, pump):
    jprep, prep = _plane_pair(S, D, pump)
    img = _port_wave(prep)
    _bitwise(img, _jax_wave_eager(jprep))
    assert img.min() > 0.0


@pytest.mark.parametrize("S,D,pump", SDP)
def test_gradcheck_vs_op_by_op_jax(S, D, pump):
    jprep, prep = _gradcheck_pair(S, D, pump)
    img = _port_wave(prep)
    want = _jax_wave_eager(jprep)
    if D == 0:
        _bitwise(img, want)
    same = (img.view(np.uint32) == want.view(np.uint32)).all(axis=-1)
    assert same.mean() > 0.99, same.mean()
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=0.005)
    assert img.max() > 0.1


@pytest.mark.parametrize("km", [1.0, 0.7])
def test_mirror_furnace(km):
    """km = 1: every draw takes the mirror, which reflects the camera ray
    up into the background E, untinted: E exactly on every pixel."""
    jprep, prep = _plane_pair(3, 2, 2, base_color=(127.5,) * 3, bg=(E, E, E), intensity=0.0,
                              km=km, reflective=True)
    assert prep.setup.gi_spec
    img = _port_wave(prep)
    _bitwise(img, _jax_wave_eager(jprep))
    if km == 1.0:
        np.testing.assert_allclose(img, E, rtol=1e-6)
    else:  # the diffuse draws see rho * E
        assert (np.abs(img - E) > 1.0).any()


@pytest.fixture(scope="module")
def parallel_turbo():
    """The turbo parallel scene with GI (S = 2, D = 3): gi_pump does not
    apply (TUNED_KNOBS["parallel"] has none), the mirror mix does."""
    cfg = apply_turbo(_replace(scenes.parallel_scene_config(SIZE, SIZE), gi_samples=2,
                               gi_depth=3), "parallel")
    jcfg = jax_apply_turbo(_replace(jax_scenes.parallel_scene_config(SIZE, SIZE),
                                    gi_samples=2, gi_depth=3), "parallel")
    prep = prepare(cfg, device="cpu")
    return prep, jax_renderer.prepare(jcfg), _port_wave(prep)


def test_parallel_turbo_vs_jax(parallel_turbo):
    prep, jprep, img = parallel_turbo
    assert prep.setup.gi_spec and prep.cfg.render.pump == jprep.cfg.render.pump
    _bitwise(img, _jax_wave_eager(jprep))
    want = np.asarray(jax_pt._render_pt_wave(jprep))
    close = (np.abs(img - want) <= 1e-5 * np.abs(want)).all(axis=-1)
    assert close.mean() > 0.85, close.mean()
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=0.10)


def test_jax_wave_does_not_depend_on_wave_or_pump():
    jprep, _ = _gradcheck_pair(3, 2, 1)
    a = np.asarray(jax_pt._render_pt_wave(jprep._replace(cfg=_replace(jprep.cfg, wave=64))))
    b = np.asarray(jax_pt._render_pt_wave(jprep._replace(
        cfg=_replace(jprep.cfg, wave=256, pump=4))))
    _bitwise(a, b)


def _plain_inputs(prep):
    return gi_wave.launch_inputs(prep)


def _counters():
    return dict(capped_out=torch.zeros(1, dtype=torch.int32),
                passes_out=torch.zeros(1, dtype=torch.int32),
                events_out=torch.zeros(len(gi_wave.EVENTS), dtype=torch.int64))


def test_colors_and_counters_do_not_depend_on_pixel_order(parallel_turbo):
    prep = parallel_turbo[0]
    tail, kw = _plain_inputs(prep)
    rays = camera_rays(prep.cfg.camera, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(3).permutation(rays.count))
    c1, c2 = _counters(), _counters()
    a = gi_wave.gi_wave_plain(rays, *tail, **kw, **c1)
    b = gi_wave.gi_wave_plain(RayBatch(*(x[perm] for x in rays)), *tail, **kw, **c2)
    _bitwise(b.numpy(), a[perm].numpy())
    for key in c1:
        assert torch.equal(c1[key], c2[key]), key
    _bitwise(vm.div_scalar(a, 2.0).reshape(SIZE, SIZE, 3).numpy(), parallel_turbo[2])
    ev = dict(zip(gi_wave.EVENTS, c1["events_out"].tolist()))
    assert int(c1["capped_out"]) == 0
    assert ev["mirror_draws"] > 0 and ev["shadow_rays"] > 0 and ev["escapes"] > 0
    assert ev["vertices"] <= ev["primaries"] + ev["bounce_segments"]
    assert 0 < int(c1["passes_out"]) <= ev["slot_tests"]
    # a tile of 37 pixels gives the same image
    tiled = render(prep._replace(cfg=_replace(prep.cfg, ray_tile=37)))
    _bitwise(tiled.numpy(), parallel_turbo[2])


def test_wave_vs_segment_loop(parallel_turbo):
    """The JAX package's rule for its own wave against its segment loop:
    more than 97% of pixels within 1e-5, the means within 2% (on the
    gradcheck scene with the mirror mix, and the parallel scene)."""
    _, grad = _gradcheck_pair(2, 2, 2, size=24, mirror=True)
    for prep, img in ((grad, _port_wave(grad)), (parallel_turbo[0], parallel_turbo[2])):
        seg = render(prep._replace(cfg=_replace(prep.cfg, gi_wave="off"))).numpy()
        same = (np.abs(img - seg) <= 1e-5).all(axis=-1)
        assert same.mean() > 0.97, same.mean()
        np.testing.assert_allclose(img.mean(), seg.mean(), rtol=0.02)


@pytest.mark.parametrize("name", ["serial", "parallel"])
def test_wave_tables_equal_jax(name):
    cfg = getattr(scenes, name + "_scene_config")(8, 8)
    jcfg = getattr(jax_scenes, name + "_scene_config")(8, 8)
    scene = scenes.build_scene(cfg, device="cpu")
    jscene = jax_scenes.build_scene(jcfg)
    rc, jrc = cfg.render, jcfg.render
    spec = pt.use_gi_wave_spec(scene, rc)
    assert spec == jax_pt.use_gi_wave_spec(jscene, jrc) == (name == "parallel")
    _bitwise(pt.build_gi_wave_tri9(scene).numpy(), jax_pt.build_gi_wave_tri9(jscene))
    tab = pt.build_gi_wave_tables(scene, rc, spec)
    albedo, km = tab.albedo, tab.km
    jtab = jax_pt.build_gi_wave_tables(jscene, jrc, spec)
    _bitwise(albedo.numpy(), jtab[0])
    _bitwise(tab.tri9.numpy(), jax_pt.build_gi_wave_tri9(jscene))
    assert all(x is None for x in tab[2:6])
    if spec:
        _bitwise(km.numpy(), jtab[1])
    else:
        assert km is None and jtab[1] is None
    assert all(x is None for x in jtab[2:])  # no texture or smooth-normal tables


def test_unserved_wave_arguments_raise(parallel_turbo):
    """The sharded queue raises; an environment map, served since, is the
    plain version's: a constant map gives what the same constant as the
    flat background gives, bitwise."""
    prep = parallel_turbo[0]
    tail, kw = _plain_inputs(prep)
    args = tail[:6]
    kw = {k: v for k, v in kw.items() if k in ("S", "D")}
    sky = (7.0, 5.0, 3.0)
    with_env = gi_wave.gi_wave_trace(*args, env_image=torch.tensor(sky).expand(4, 8, 3),
                                     camera=prep.cfg.camera, **kw)
    _bitwise(with_env.numpy(),
             gi_wave.gi_wave_trace(*args, camera=prep.cfg.camera, bg=sky, **kw).numpy())
    with pytest.raises(NotImplementedError, match="sharded"):
        gi_wave.gi_wave_trace(*args, camera=prep.cfg.camera, pix_stride=2, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        gi_wave.gi_wave_cuda(prep.cfg.camera, *args, **kw)


@pytest.mark.parametrize("n,S", [(1, 1), (7500, 3), (16384, 8), (1 << 20, 4)])
def test_scratch_layout_is_sized_for_every_pixel_queued(n, S):
    """heads (4 int32), a flag (int32) and an 80-byte record a pixel, v_s
    (3 float32) a (pixel, sample) item: in order, 16-byte aligned (the
    records are read as float4), disjoint, and no larger than alignment
    needs."""
    layout = gi_wave._scratch_layout(n, S)
    end = 0
    for name, size in (("heads", 16), ("flags", 4 * n), ("recs", 80 * n), ("v", 12 * n * S)):
        assert layout[name] % 16 == 0 and layout[name] >= end, name
        assert layout[name] - end < 16, name
        end = layout[name] + size
    assert end <= layout["total"] < end + 16


@pytest.mark.parametrize("n", [1, 127, 128, 129, 7500, 1 << 20])
def test_stage_launch_values(n):
    """Stage P has a thread for every pixel and no block without one;
    stage S takes every SM's resident blocks (one an SM if none was
    reported); the fold's grid-stride loop has at most 8 blocks an SM and
    no more blocks than 256 pixels need."""
    grid_p, grid_s, grid_fold = gi_wave._stage_launch(n, 132, 8)
    assert (grid_p - 1) * 128 < n <= grid_p * 128
    assert grid_s == 132 * 8
    assert gi_wave._stage_launch(n, 132, 0)[1] == 132
    assert 1 <= grid_fold <= min(8 * 132, -(-n // 256))
    assert grid_fold == 8 * 132 or grid_fold * 256 >= n


_CSRC = os.path.join(os.path.dirname(gi_wave.__file__), os.pardir, "csrc")


def _source(name):
    with open(os.path.join(_CSRC, name)) as fh:
        return re.sub(r"//[^\n]*", "", fh.read())


def _c_fields(src, struct):
    """[(name, C type, count)] of `struct <struct> { ... };` in src."""
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, names = decl.split(None, 1)
        for name in names.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", name.strip())
            out.append((m.group(1), ctype, int(m.group(2) or 1)))
    return out


def test_gi_params_mirror_the_c_struct():
    """_GiParams, passed by value, has GiParams's fields in its order and
    types, so every offset agrees (and its MarchParams is the march's)."""
    from ray_tracer_tpu_torch.ops.traverse_packed import _MarchParams

    scalar = {"float": ctypes.c_float, "int": ctypes.c_int}
    mirrors = {"MarchParams": _MarchParams}
    fields = _c_fields(_source("gi_wave.cu"), "GiParams")
    assert [f[0] for f in fields] == [f[0] for f in gi_wave._GiParams._fields_]
    for (name, ctype, count), (_, mirror) in zip(fields, gi_wave._GiParams._fields_):
        want = mirrors.get(ctype) or scalar[ctype]
        assert mirror == (want if count == 1 else want * count), name
    march = _c_fields(_source("packed_step.cuh"), "MarchParams")
    assert [f[0] for f in march] == [f[0] for f in _MarchParams._fields_]
    assert ctypes.sizeof(gi_wave._GiParams) == ctypes.sizeof(_MarchParams) + 4 * (5 + 6 + 7)


def test_appear_params_mirror_the_c_struct():
    """_AppearParams, passed by value, has AppearParams's fields in its
    order and types (csrc/texture.cuh): five table pointers, the texture
    scale and four image extents."""
    body = re.search(r"struct AppearParams \{(.*?)\};", _source("texture.cuh"), re.S).group(1)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype = ctypes.c_void_p if "*" in decl else {"float": ctypes.c_float,
                                                     "int": ctypes.c_int}[decl.split()[0]]
        for name in decl.replace("*", " ").split()[-1 if "*" in decl else 1:]:
            fields += [(n.strip(), ctype) for n in name.split(",") if n.strip()]
    assert fields == list(gi_wave._AppearParams._fields_)
    assert ctypes.sizeof(gi_wave._AppearParams) == 5 * 8 + 4 + 4 * 4 + 4  # padded to 8


def test_launch_constants_mirror_the_c_source():
    """The wrapper's block sizes and record size are the kernel's."""
    src = _source("gi_wave.cu")

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))

    assert gi_wave._BLOCK == const("kBlock")
    assert gi_wave._FOLD_BLOCK == const("kFoldBlock")
    assert gi_wave._RECORD_BYTES == 16 * const("kRecord")


def test_launch_argtypes_mirror_the_c_signature():
    """The ctypes argument list of gi_wave_launch: a pointer for each
    pointer, c_int for each int, the two structs by value."""
    src = _source("gi_wave.cu")
    params = re.search(r'extern "C" int gi_wave_launch\((.*?)\)\s*\{', src, re.S).group(1)
    want = []
    for param in (p.strip() for p in params.split(",")):
        if "*" in param:
            want.append(ctypes.c_void_p)
        elif param.startswith("GiParams "):
            want.append(gi_wave._GiParams)
        elif param.startswith("CameraParams "):
            want.append(gi_wave._CameraParams)
        elif param.startswith("AppearParams "):
            want.append(gi_wave._AppearParams)
        else:
            assert param.startswith("int "), param
            want.append(ctypes.c_int)
    lib = types.SimpleNamespace(gi_wave_launch=types.SimpleNamespace())
    assert gi_wave._launch_fn(lib).argtypes == want
    assert len(want) == 23


def test_gi_wave_cuda_refuses_cpu_tensors(parallel_turbo):
    """Kernel F's wrapper takes CUDA tensors only; it never falls back to
    the plain version, and counts no launch."""
    prep = parallel_turbo[0]
    tail, kw = _plain_inputs(prep)
    before = gi_wave.gi_wave_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gi_wave.gi_wave_cuda(prep.cfg.camera, *tail, **kw,
                             lanes_out=torch.zeros((2, 3), dtype=torch.int64))
    assert gi_wave.gi_wave_cuda.launches == before
