"""The sharded queue of the port's Whitted wave (kernel E's plain version)
against the JAX package's `whitted_wave_trace` with the same pix_offset,
pix_stride and queue_len, run op by op (`jax.disable_jit()`), whose wave
of queue_len lanes serves every position at once.

The mirror scene of tests/test_torch_whitted_wave.py (the gradcheck scene
with a reflective sphere, one bounce, a background) at 32x32, dealt to 4
shards of 257 positions, contiguous (position k of shard s the pixel
257 s + k) and round-robin (the pixel s + 4 k): the last positions map
past the 1,024 pixels and are dead.  Each shard's colors, dead rows
included, are bitwise JAX's, and the shards composed are bitwise the
unsharded wave's image.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops import whitted_wave as jax_wave  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import whitted_wave as wave  # noqa: E402
from ray_tracer_tpu_torch.parallel.shard import stride_permutation  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

SIZE = 32
SHARDS = 4
QUEUE = SIZE * SIZE // SHARDS + 1  # one position more a shard: dead rows
BACKGROUND = (25.0, 10.0, 5.0)
RENDER_KW = dict(faithful=False, det_dtype="float32", traversal="packed",
                 scheduler="persistent", wave=QUEUE, pump=1, max_bounces=1, fused_shadow=True,
                 whitted_wave="auto", background=BACKGROUND)


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _queues(layout):
    if layout == "contiguous":
        return [(QUEUE * s, 1) for s in range(SHARDS)]
    return [(s, SHARDS) for s in range(SHARDS)]


@pytest.fixture(scope="module")
def mirror():
    """(port prep, JAX prep) of the mirror scene."""
    jscene, jcfg = jax_scenes.gradcheck_scene(SIZE, SIZE)
    jscene = jscene._replace(materials=jscene.materials._replace(
        reflective=jnp.asarray([False, True]), km=jnp.asarray([0.0, 0.6], jnp.float32)))
    scene, cfg = scenes.gradcheck_scene(SIZE, SIZE, device="cpu")
    scene = scene._replace(materials=scene.materials._replace(
        reflective=torch.tensor([False, True]), km=torch.tensor([0.0, 0.6])))
    return (prepare(_replace(cfg, **RENDER_KW), scene=scene),
            jax_renderer.prepare(_replace(jcfg, **RENDER_KW), scene=jscene))


def _kw(cfg):
    rc = cfg.render
    pg = rc.primary_gate()
    return dict(camera=cfg.camera, max_bounces=rc.max_bounces, serial=rc.serial_shading,
                gate0=0.0 if pg is None else pg, gate_b=rc.bounce_gate(), eps=rc.shadow_eps,
                smint=rc.shadow_mint(), quirk=rc.shadow_dir_away_from_light(),
                shadow_scale=rc.shadow_scale, bg=tuple(rc.background))


def _port(prep, **queue):
    mat9, tri9 = prep.wave
    return wave.whitted_wave_trace(prep.scene.light_pos, prep.scene.light_intensity, mat9, tri9,
                                   prep.packed.arrays, prep.packed.meta, **_kw(prep.cfg),
                                   **queue).numpy()


def _jax(jprep, offset, stride):
    mat9, tri9 = jax_wave.build_wave_tables(jprep.scene)
    with jax.disable_jit():
        out = jax_wave.whitted_wave_trace(
            jprep.scene.light_pos, jprep.scene.light_intensity, mat9, tri9,
            jprep.packed.arrays, jprep.packed.meta, wave=QUEUE, pump=1,
            pix_offset=jnp.int32(offset), pix_stride=stride, queue_len=QUEUE,
            **_kw(jprep.cfg))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("shard", range(SHARDS))
@pytest.mark.parametrize("layout", ["contiguous", "round_robin"])
def test_shard_queue_bitwise_vs_op_by_op_jax(mirror, layout, shard):
    prep, jprep = mirror
    assert prep.setup.wave
    offset, stride = _queues(layout)[shard]
    got = _port(prep, pix_offset=offset, pix_stride=stride, queue_len=QUEUE)
    want = _jax(jprep, offset, stride)
    assert got.shape == want.shape == (QUEUE, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    dead = offset + np.arange(QUEUE) * stride >= SIZE * SIZE
    assert dead.any() == (layout == "round_robin" or shard == SHARDS - 1)
    assert (got[dead] == np.asarray(BACKGROUND, np.float32)).all()


@pytest.mark.parametrize("layout", ["contiguous", "round_robin"])
def test_shards_compose_to_the_unsharded_wave(mirror, layout):
    prep, _ = mirror
    parts = [_port(prep, pix_offset=o, pix_stride=s, queue_len=QUEUE)
             for o, s in _queues(layout)]
    perm = (np.arange(QUEUE * SHARDS) if layout == "contiguous"
            else stride_permutation(QUEUE * SHARDS, SHARDS))
    composed = np.concatenate(parts)[np.argsort(perm)][:SIZE * SIZE]
    whole = render(prep).numpy().reshape(-1, 3)
    np.testing.assert_array_equal(composed.view(np.uint32), whole.view(np.uint32))
