"""The port's workload scenes (models/meshes.py, models/scenes.py) against
the JAX package's.

* `make_displaced_sphere` at its default 256x512 (the nefertiti stand-in,
  about 262k faces), `make_reference_plane` and the text `write_obj`
  writes are byte-equal to JAX's.
* The nefertiti scene (reduced to a 32x64 sphere) has the JAX scene's
  arrays, and its packed grid at the tuned nefertiti knobs is byte-equal
  to JAX's, with and without the spot mesh.
* A 32x32 nefertiti render (a 64x128 sphere) is held to jitted JAX by the
  2-count rule: the u8 images differ by more than 2 counts on under 1% of
  pixels (jitted XLA contracts the Cramer arithmetic, so t differs in
  the last bits).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import apply_turbo as jax_apply_turbo  # noqa: E402
from ray_tracer_tpu.models import meshes as jax_meshes  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.io.obj import MeshArrays  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.models import meshes, scenes  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402


def _mesh_bytes_equal(got, want):
    for field in ("verts", "faces", "uvs", "uv_faces"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def test_displaced_sphere_default_byte_equal():
    got = meshes.make_displaced_sphere()
    _mesh_bytes_equal(got, jax_meshes.make_displaced_sphere())
    assert got.faces.shape[0] == 2 * 256 * 512 - 2 * 512  # no degenerate pole faces


@pytest.mark.parametrize("kw", [dict(n_lat=8, n_lon=16, radius=1.2, seed=3),
                                dict(n_lat=33, n_lon=64, displacement=0.3)])
def test_displaced_sphere_options_byte_equal(kw):
    _mesh_bytes_equal(meshes.make_displaced_sphere(**kw), jax_meshes.make_displaced_sphere(**kw))


def test_reference_plane_byte_equal():
    got = meshes.make_reference_plane()
    _mesh_bytes_equal(got, jax_meshes.make_reference_plane())
    assert got.verts.shape == (10404, 3) and got.faces.shape == (20402, 3)


def test_write_obj_text_equal(tmp_path):
    """The same text for a generated mesh and for one whose second face has
    no vt (written as a bare `f a b c`)."""
    sphere = meshes.make_displaced_sphere(n_lat=4, n_lon=6)
    uvf = np.array([[0, 1, 2], [-1, -1, -1], [2, 1, 0]], np.int32)
    partial = MeshArrays(sphere.verts[:3].copy(), np.array([[0, 1, 2]] * 3, np.int32),
                         np.array([[0.0, 0.5], [0.25, 1.0], [1.0, 0.0]], np.float32), uvf)
    for i, mesh in enumerate((sphere, partial)):
        ours, theirs = tmp_path / f"ours{i}.obj", tmp_path / f"jax{i}.obj"
        meshes.write_obj(str(ours), mesh)
        jax_meshes.write_obj(str(theirs), mesh)
        assert ours.read_text() == theirs.read_text()


def test_flagship_scene_is_the_serial_scene():
    scene, cfg = scenes.flagship_scene(16, 16, device="cpu")
    jscene, jcfg = jax_scenes.flagship_scene(16, 16)
    assert cfg.camera.width == jcfg.camera.width == 16
    assert cfg.render.shading == jcfg.render.shading == "serial"
    np.testing.assert_array_equal(scene.verts.numpy(), np.asarray(jscene.verts))
    np.testing.assert_array_equal(scene.faces.numpy(), np.asarray(jscene.faces))


@pytest.mark.parametrize("with_spot", [False, True], ids=["bust", "bust_spot"])
def test_nefertiti_scene_and_packed_tables_equal(with_spot):
    """The reduced nefertiti scene: its arrays, config and, at the tuned
    nefertiti knobs (apply_turbo), its packed tables equal JAX's."""
    kw = dict(n_lat=32, n_lon=64, with_spot=with_spot)
    scene, cfg = scenes.nefertiti_scene(16, 16, device="cpu", **kw)
    jscene, jcfg = jax_scenes.nefertiti_scene(16, 16, **kw)
    for field in ("verts", "faces", "face_material"):
        a, b = getattr(scene, field).numpy(), np.asarray(getattr(jscene, field))
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=field)
    np.testing.assert_array_equal(scene.materials.base_color.numpy(),
                                  np.asarray(jscene.materials.base_color))
    np.testing.assert_array_equal(scene.light_pos.numpy(), np.asarray(jscene.light_pos))
    assert dataclasses.asdict(cfg.camera) == dataclasses.asdict(jcfg.camera)
    assert cfg.render.traversal == jcfg.render.traversal == "packed"
    tcfg = apply_turbo(cfg, "nefertiti")
    prep = prepare(tcfg, scene=scene)
    jprep = jax_renderer.prepare(jax_apply_turbo(jcfg, "nefertiti"), scene=jscene)
    assert tuple(prep.packed.meta) == tuple(jprep.packed.meta)
    for field in ("blocks", "slot_tri", "cell_info", "lower", "upper", "width", "inv_width"):
        a = getattr(prep.packed.arrays, field).numpy()
        b = np.asarray(getattr(jprep.packed.arrays, field))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("turbo", [True, False], ids=["turbo", "scene_config"])
def test_nefertiti_render_two_count_rule(turbo):
    """The scene's own config (the tiled packed march, fused shadow) and the
    tuned one (persistent fused march) against jitted JAX."""
    kw = dict(n_lat=64, n_lon=128)
    scene, cfg = scenes.nefertiti_scene(32, 32, device="cpu", **kw)
    jscene, jcfg = jax_scenes.nefertiti_scene(32, 32, **kw)
    if turbo:
        cfg, jcfg = apply_turbo(cfg, "nefertiti"), jax_apply_turbo(jcfg, "nefertiti")
    img = render(prepare(cfg, scene=scene)).numpy()
    want = np.asarray(jax_renderer.render(jax_renderer.prepare(jcfg, scene=jscene)))
    a, b = tonemap_u8(img), tonemap_u8(want)
    over = (np.abs(a.astype(int) - b.astype(int)).max(axis=-1) > 2).mean()
    assert over < 0.01
    assert (a.max(axis=-1) > 0).mean() > 0.2  # the bust fills the frame
