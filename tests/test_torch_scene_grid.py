"""The port's host data against the JAX package: scene arrays and the
numpy CSR grid build, byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.accel.grid import build_grid as jax_build_grid  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu_torch.accel.grid import build_grid, grid_from_numpy  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["serial", "parallel"])
def test_scene_numpy_arrays_byte_equal(name):
    """verts, faces, fmat, uvs, uv_faces: identical dtype, shape, bytes."""
    mk = f"{name}_scene_config"
    want = jax_scenes.scene_numpy_arrays(getattr(jax_scenes, mk)(16, 16))
    got = scenes.scene_numpy_arrays(getattr(scenes, mk)(16, 16))
    for w, g in zip(want, got):
        _same_bytes(w, g)


def test_gradcheck_scene_equal():
    """The procedural gradcheck scene: same geometry, materials, light."""
    js, jcfg = jax_scenes.gradcheck_scene(16, 16)
    ts, tcfg = scenes.gradcheck_scene(16, 16, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _same_bytes(np.asarray(js.verts), ts.verts.numpy())
    np.testing.assert_array_equal(np.asarray(js.faces), ts.faces.numpy())
    np.testing.assert_array_equal(np.asarray(js.face_material), ts.face_material.numpy())
    np.testing.assert_array_equal(np.asarray(js.uv_faces), ts.uv_faces.numpy())
    for jf, tf in zip(js.materials, ts.materials):
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    _same_bytes(np.asarray(js.light_pos), ts.light_pos.numpy())


@pytest.mark.parametrize("name", ["serial", "parallel"])
def test_scene_configs_equal(name):
    """Same field names and values, defaults included, so one config means
    one render in both packages."""
    mk = f"{name}_scene_config"
    assert (dataclasses.asdict(getattr(scenes, mk)(32, 16))
            == dataclasses.asdict(getattr(jax_scenes, mk)(32, 16)))


def _arrays(name):
    if name == "gradcheck":
        return scenes.concat_mesh_arrays(scenes.gradcheck_mesh_parts())[:2]
    return scenes.scene_numpy_arrays(getattr(scenes, f"{name}_scene_config")(8, 8))[:2]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ["serial", "parallel", "gradcheck"])
def test_build_grid_equals_jax_numpy_build(name, exact):
    """cell_start, tri_ids, dimensions and the float frame equal the JAX
    numpy build (`use_native=False`), with exact_overlap off and on."""
    verts, faces = _arrays(name)
    want = jax_build_grid(verts, faces, use_native=False, exact_overlap=exact)
    got = build_grid(verts, faces, exact_overlap=exact, device="cpu")
    assert got.meta == tuple(want.meta)
    np.testing.assert_array_equal(got.host.cell_start, want.host.cell_start)
    np.testing.assert_array_equal(got.arrays.cell_start.numpy(), want.host.cell_start)
    np.testing.assert_array_equal(got.arrays.tri_ids.numpy(), want.host.tri_ids)
    for f in ("lower", "upper", "width", "inv_width"):
        _same_bytes(getattr(got.arrays, f).numpy(), np.asarray(getattr(want.arrays, f)))


def test_grid_from_numpy_carries_a_jax_grid():
    """grid_from_numpy turns a JAX GridHost into the port's grid."""
    verts, faces = _arrays("gradcheck")
    want = jax_build_grid(verts, faces, use_native=False)
    got = grid_from_numpy(want.host, want.meta.n_voxels, device="cpu")
    assert got.meta == tuple(want.meta)
    np.testing.assert_array_equal(got.arrays.tri_ids.numpy(), want.host.tri_ids)
    with pytest.raises(ValueError):
        grid_from_numpy(want.host, (1, 1, 1), device="cpu")
