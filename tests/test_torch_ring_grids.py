"""The ring's host builds against the JAX package's, byte for byte:

* `build_grid(force_resolution=)` on a contiguous face slice at the
  replicated build's resolution (the numpy build on both sides: JAX skips
  its native grid build when the resolution is forced);
* `pack_grid(as_numpy=True)`: numpy arrays, not uploaded, cell_info as the
  uint32 word's int32 bits;
* `parallel.shard.build_ring_grids` at 2 and 4 shards: the stacked arrays
  (blocks padded to the largest shard with zero rows and -1 slots), the
  shared meta (largest block count and max_blocks, smallest probe_delta,
  the blocks layout even when the prepared grid is inline) and the padded
  face count, on the gradcheck scene (inline turbo layout) and the
  parallel scene (54,674 faces: padding faces at 4 shards) (each rank's
  own `build_ring_shard` is held to its shard in tests/test_torch_ring.py);
* `pack_grid(pad_meta=)` stays refused (a rebuild is prepare() at the
  built meta).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.accel import packed as jax_packed  # noqa: E402
from ray_tracer_tpu.accel.grid import build_grid as jax_build_grid  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.parallel import shard as jax_shard  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.accel import packed  # noqa: E402
from ray_tracer_tpu_torch.accel.grid import build_grid  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.models.scenes import host_geometry  # noqa: E402
from ray_tracer_tpu_torch.parallel.shard import build_ring_grids  # noqa: E402
from ray_tracer_tpu_torch.render import renderer  # noqa: E402

RING = dict(faithful=False, det_dtype="float32", traversal="packed", fused_shadow=False)


def _preps(name):
    """(the port's prepared scene, the JAX package's) at 8x8, packed."""
    if name == "gradcheck":
        scene, cfg = scenes.gradcheck_scene(8, 8, device="cpu")
        jscene, jcfg = jax_scenes.gradcheck_scene(8, 8)
        kw = dict(RING, grid_layout="inline")
    else:
        cfg, jcfg = scenes.parallel_scene_config(8, 8), jax_scenes.parallel_scene_config(8, 8)
        scene = jscene = None
        kw = RING

    def rep(c):
        return dataclasses.replace(c, render=dataclasses.replace(c.render, **kw))

    return (renderer.prepare(rep(cfg), scene=scene, device="cpu"),
            jax_renderer.prepare(rep(jcfg), scene=jscene))


@pytest.fixture(scope="module")
def preps():
    return {name: _preps(name) for name in ("gradcheck", "parallel")}


def _bytes_equal(got, want, field):
    a = np.asarray(got)
    b = np.asarray(want)
    assert a.shape == b.shape, field
    assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("name", ["gradcheck", "parallel"])
@pytest.mark.parametrize("part", [0, 1])
def test_build_grid_force_resolution(preps, name, part):
    prep, jprep = preps[name]
    verts, faces = host_geometry(prep.scene)
    half = faces.shape[0] // 2
    sl = faces[part * half:(part + 1) * half]
    res = prep.grid.meta.n_voxels
    k = prep.cfg.render.grid
    got = build_grid(verts, sl, k.resolution_multiplier, k.max_resolution,
                     exact_overlap=k.exact_overlap, device="cpu", force_resolution=res)
    want = jax_build_grid(verts, sl, k.resolution_multiplier, k.max_resolution,
                          force_resolution=res, exact_overlap=k.exact_overlap)
    assert tuple(got.meta) == tuple(want.meta)
    assert got.meta.n_voxels == tuple(res)
    for field in got.host._fields:
        _bytes_equal(getattr(got.host, field), getattr(want.host, field), field)


@pytest.mark.parametrize("name", ["gradcheck", "parallel"])
def test_pack_grid_as_numpy(preps, name):
    prep, jprep = preps[name]
    verts, faces = host_geometry(prep.scene)
    got = packed.pack_grid(prep.grid, verts, faces, block_tris=14, as_numpy=True)
    want = jax_packed.pack_grid(jprep.grid, verts, faces, block_tris=14, as_numpy=True)
    assert tuple(got.meta) == tuple(want.meta)
    for field in got.arrays._fields:
        assert isinstance(getattr(got.arrays, field), np.ndarray), field
        _bytes_equal(getattr(got.arrays, field), getattr(want.arrays, field), field)
    with pytest.raises(NotImplementedError, match="pad_meta"):
        packed.pack_grid(prep.grid, verts, faces, pad_meta=got.meta)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["gradcheck", "parallel"])
def test_build_ring_grids_byte_equal(preps, name, shards):
    prep, jprep = preps[name]
    got = build_ring_grids(prep, shards)
    jarr, jmeta, jfp = jax_shard.build_ring_grids(jprep, shards)
    arrays, meta, fp = got.arrays, got.meta, got.fp
    assert fp == jfp and fp % shards == 0
    assert tuple(meta) == tuple(jmeta)
    assert not meta.inline
    for field in arrays._fields:
        a = getattr(arrays, field)
        assert a.device.type == "cpu" and a.shape[0] == shards, field
        _bytes_equal(a.numpy(), getattr(jarr, field), field)
    if name == "gradcheck":
        assert prep.packed.meta.inline  # the ring builds the blocks layout all the same
    elif shards == 4:
        assert fp > prep.scene.num_faces  # padding faces at vertex 0
