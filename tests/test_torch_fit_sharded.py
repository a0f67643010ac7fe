"""The port's data-parallel train step and fit (opt/fit.py with mesh=) on
gloo groups of 2 and 4 CPU ranks (tests/torch_ranks.py), against the
unsharded step and the JAX package's sharded step on the 8-device CPU mesh
(tests/test_sharding.py:59, tests/test_opt.py:229, :277, :310).

Each case takes two sharded Adam steps, each beside an unsharded step from
the same parameters: the loss to rtol 1e-6 (the all-reduce adds the
shards' sums in another order than one torch.sum), every gradient to rtol
1e-4 with atol 1e-6 max|g|, and the parameters bitwise equal on every rank
after every step.  The cases: the gradcheck scene at 16x16; at 15x13 with
an environment map, whose padding lanes see the map and are masked by
their inf origins; spp 2, whole and padded by whole pixels (pixel-major
rays).  Besides, a perfect self-target under an environment map on 5x5
pixels gives a zero loss, and the sharded fit() with a grid rebuild every
step keeps to the single-device fit's losses (rtol 1e-6).  The first
step's loss is JAX's sharded step's to rtol 1e-6.  The ring train step
(tests/test_torch_ring_fit.py) refuses what the JAX one refuses: a
faithful config.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu_torch.opt import fit  # noqa: E402
from torch_ranks import FIT_CASES, fit_case, run_ranks  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: run_ranks("sharded_steps", w, tmp_path_factory.mktemp(f"f{w}")) for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FIT_CASES)
def test_sharded_step_matches_unsharded(ranks, name, world):
    steps = ranks[world][0][name]
    for k, step in enumerate(steps):
        np.testing.assert_allclose(step["loss"], step["unsharded_loss"], rtol=1e-6)
        for f, g in step["grads"].items():
            u = step["unsharded_grads"][f]
            np.testing.assert_allclose(g, u, rtol=1e-4, atol=1e-6 * float(np.abs(u).max()),
                                       err_msg=f"step {k}, {f}")
    assert steps[1]["loss"] < steps[0]["loss"]
    for rank, res in enumerate(ranks[world]):
        same = [s["same_on_every_rank"] for s in res[name]] if rank == 0 else res[name]
        assert all(all(step.values()) for step in same), (rank, same)


@pytest.mark.parametrize("world", WORLDS)
def test_padding_lanes_masked_and_fit_loop(ranks, world):
    res = ranks[world][0]
    assert res["env_selftarget_loss"] < 1e-10
    loop = res["fit_loop"]
    assert len(loop["sharded"]) == 3
    np.testing.assert_allclose(loop["sharded"], loop["single"], rtol=1e-6)


@pytest.mark.parametrize("name", ["csr", "spp2"])
def test_first_step_loss_matches_jax_sharded(ranks, eight_device_mesh, name):
    import dataclasses

    import jax.numpy as jnp

    from ray_tracer_tpu.models.scenes import gradcheck_scene
    from ray_tracer_tpu.opt.fit import make_train_step, split_scene
    from ray_tracer_tpu.render.renderer import prepare

    _, target, trainable = fit_case(name)
    scene, cfg = gradcheck_scene(16, 16)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, ray_tile=64, spp=2 if name == "spp2" else 1))
    prep = prepare(cfg, scene=scene)
    step, init = make_train_step(prep.grid.meta, prep.cfg, lr=1e-3, mesh=eight_device_mesh,
                                 axis="rays", trainable=trainable)
    params = split_scene(prep.scene)
    _, _, loss = step(params, init(params), prep.scene, prep.grid.arrays,
                      jnp.asarray(target.numpy()))
    np.testing.assert_allclose(ranks[4][0][name][0]["loss"], float(loss), rtol=1e-6)


def test_ring_train_step_refused():
    """The ring has production semantics only: a faithful config is
    refused, as the JAX package's _check_ring_cfg refuses it."""
    import dataclasses

    from torch_ranks import one_rank_group

    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    prep, target, _ = fit_case("csr")
    prep = prep._replace(cfg=dataclasses.replace(prep.cfg, render=dataclasses.replace(
        prep.cfg.render, faithful=True)))
    with one_rank_group():
        ring = make_mesh(1, ("tris",), shape=(1,), devices="cpu")
        step, init, ring_scene = fit.make_ring_train_step(prep, ring, rays_axis=None)
        params, opt = init(fit.split_scene(prep.scene))
        with pytest.raises(ValueError, match="production semantics"):
            step(params, opt, ring_scene, target)
