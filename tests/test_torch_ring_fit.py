"""The port's ring train step (opt/fit.make_ring_train_step: the loss of
parallel/shard.ring_loss, its backward along the ring and the gradients
summed over both mesh axes) on gloo groups of 2 and 4 CPU ranks
(tests/torch_ranks.py: `ring_steps`; world 2 one "tris" axis, world 4
(2, 2) ("rays", "tris")), SGD at lr 1e-3 from the gradcheck scene at 16x16
against a constant target:

* without bounces (grid and all-pairs hops, and all-pairs at spp 2, whose
  rays are pixel-major): loss within rtol 1e-6 and every gradient (verts,
  base_color, km, light_pos) within rtol 1e-4, atol 1e-6 max|g| of the
  port's unsharded step from the same parameters.  At world >= 2 the rays
  of one rank hit triangles of the other, whose vertices ride the ring
  home: a vertex gradient lost on the way back fails this;
* with mirror bounces the ring's recomputed t takes each bounce origin as
  a constant (the JAX package's _ring_shade), so the parameters after the
  step are held to JAX's own test tolerances (tests/test_sharding.py:
  293-350: verts atol 1e-5, the others rtol 1e-4) against the unsharded
  step, and so is JAX's ring step on the same mesh shape;
* the parameters are bitwise equal on every rank after every step, and
  two steps lower the loss.  Past the first step the packed cases are not
  held to the unsharded step: the ring's grids keep the first vertices,
  so a moved vertex can flip a bounce ray between the two grids' cells.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.config import LightConfig as JaxLight  # noqa: E402
from ray_tracer_tpu.models.scenes import gradcheck_scene as jax_gradcheck  # noqa: E402
from ray_tracer_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from torch_ranks import RING_CASES, RING_ENV, RING_EXTRA_LIGHT, RING_STEPS, RING_TRAINABLE  # noqa: E402
from torch_ranks import run_groups  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's `ring_steps` on 2 and on 4 ranks (the groups at once)."""
    return run_groups("ring_steps", WORLDS, lambda w: tmp_path_factory.mktemp(f"fit{w}"))


def _jax_case(name):
    over, change = RING_CASES[name]
    scene, cfg = jax_gradcheck(16, 16)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, ray_tile=64,
                                                              faithful=False, **over))
    if change.get("reflective"):
        scene = scene._replace(materials=scene.materials._replace(
            reflective=jnp.asarray([False, True]), km=jnp.asarray([0.0, 0.6], jnp.float32)))
    if change.get("env"):
        scene = scene._replace(env_image=jnp.asarray(RING_ENV))
    if change.get("extra_light"):
        pos, li = RING_EXTRA_LIGHT
        cfg = dataclasses.replace(cfg, extra_lights=(JaxLight(pos, li),))
    return jax_renderer.prepare(cfg, scene=scene)


def _jax_mesh(world):
    if world == 2:
        return jax_make_mesh(2, ("tris",), shape=(2,)), None
    return jax_make_mesh(4, ("rays", "tris"), shape=(2, 2)), "rays"


def _excess(g, u):
    """max(|g - u| - 1e-4 |u|) over max|u| (0 when u is all zeros)."""
    scale = float(np.abs(u).max())
    ex = float((np.abs(g - u) - 1e-4 * np.abs(u)).max())
    return ex / scale if scale else ex


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [n for n, _ in RING_STEPS])
def test_ring_train_step_vs_unsharded(ranks, name, world):
    steps = ranks[world][0][name]
    for rank in ranks[world]:
        assert all(s["same_on_every_rank"] for s in rank[name])
    bounces = name.endswith("_bounces")
    for k, s in enumerate(steps):
        if k and name.startswith("packed"):
            break  # the ring's grids hold the first vertices: flips may differ
        assert s["loss"] == pytest.approx(s["unsharded_loss"], rel=1e-6)
        for f in RING_TRAINABLE:
            g, u = s["grads"][f], s["unsharded_grads"][f]
            if bounces:
                # the params after the step, to JAX's test tolerances
                tol = dict(atol=1e-5) if f == "verts" else dict(rtol=1e-4, atol=1e-8)
                np.testing.assert_allclose(1e-3 * g, 1e-3 * u, **tol, err_msg=f)
            else:
                assert _excess(g, u) <= 1e-6, f
    if len(steps) > 1:
        assert steps[-1]["loss"] < steps[0]["loss"]


@pytest.mark.parametrize("world", WORLDS)
def test_ring_train_step_vs_jax(ranks, world):
    from ray_tracer_tpu.opt.fit import make_ring_train_step, split_scene

    mesh, rays_axis = _jax_mesh(world)
    jprep = _jax_case("packed_bounces")
    step, init, ring_scene = make_ring_train_step(jprep, mesh, rays_axis=rays_axis,
                                                  optimizer="sgd", lr=1e-3,
                                                  trainable=RING_TRAINABLE)
    p0 = split_scene(jprep.scene)
    jp, _, jloss = step(p0, init(p0), ring_scene, jnp.full((16, 16, 3), 40.0, jnp.float32))
    got = ranks[world][0]["packed_bounces"][0]
    assert got["loss"] == pytest.approx(float(jloss), rel=1e-5)
    for f in RING_TRAINABLE:
        tol = dict(atol=1e-5) if f == "verts" else dict(rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(got["params"][f], np.asarray(getattr(jp, f)), **tol,
                                   err_msg=f)
