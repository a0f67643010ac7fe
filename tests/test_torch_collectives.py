"""The port's collectives (parallel/collectives.py) on gloo groups of 2 and 4
CPU ranks (tests/torch_ranks.py), against the JAX package's on a 4-device
mesh of the 8-device CPU mesh (tests/test_sharding.py:74-116).

* scatter_rays then gather_image gives back the replicated array;
* ring_shift by +1 and -1 rolls the shards as JAX's ppermute does;
* allreduce_gradients sums (psum, not an average), keeps None leaves;
* min_reduce_hits keeps the first minimum in shard order, JAX's argmin
  rule, on data with ties and misses;
* broadcast hands every rank rank 0's tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

torch.set_num_threads(1)

from ray_tracer_tpu.parallel import collectives as jax_coll  # noqa: E402
from ray_tracer_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks_2(tmp_path_factory):
    return run_ranks("collectives", 2, tmp_path_factory.mktemp("c2"))


@pytest.fixture(scope="module")
def ranks_4(tmp_path_factory):
    return run_ranks("collectives", 4, tmp_path_factory.mktemp("c4"))


@pytest.fixture
def ranks(request, world):
    """{world: each rank's results}: a group a world, each run once, so that
    a group that fails fails its own five cases only."""
    return {world: request.getfixturevalue(f"ranks_{world}")}


def _jax(body, x, world, out_spec=P("rays")):
    mesh = jax_make_mesh(world, ("rays",))
    return np.asarray(jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("rays"),
                                            out_specs=out_spec, check_vma=False))(x))


@pytest.mark.parametrize("world", WORLDS)
def test_gather_scatter_roundtrip(ranks, world, eight_device_mesh):
    x = np.arange(world * 4 * 3, dtype=np.float32).reshape(world * 4, 3)
    for rank, res in enumerate(ranks[world]):
        np.testing.assert_array_equal(res["full"], x)
        np.testing.assert_array_equal(res["mine"], x[rank * 4:(rank + 1) * 4])
    want = _jax(lambda s: jax_coll.scatter_rays(jax_coll.gather_image(s, "rays"), "rays"),
                jnp.asarray(x), world)
    np.testing.assert_array_equal(np.concatenate([r["mine"] for r in ranks[world]]), want)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_shift(ranks, world, eight_device_mesh):
    got = np.concatenate([r["ring"] for r in ranks[world]]).ravel()
    np.testing.assert_array_equal(got, np.roll(np.arange(world), 1))
    back = np.concatenate([r["ring_back"] for r in ranks[world]]).ravel()
    np.testing.assert_array_equal(back, np.roll(np.arange(world), -1))
    want = _jax(lambda s: jax_coll.ring_shift(s, "rays", shift=1),
                jnp.arange(world, dtype=jnp.float32).reshape(world, 1), world)
    np.testing.assert_array_equal(got, want.ravel())


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_gradients_sums(ranks, world, eight_device_mesh):
    for res in ranks[world]:
        assert float(res["g"]) == 2.0 * world  # a sum, as psum: not DDP's mean
        np.testing.assert_array_equal(res["v"], np.full((3,), sum(range(world)), np.float32))
        assert res["none"] is None
    want = _jax(lambda s: jax_coll.allreduce_gradients({"g": s.sum()}, "rays")["g"],
                jnp.ones((world, 2), jnp.float32), world, out_spec=P())
    assert float(want) == float(ranks[world][0]["g"])


@pytest.mark.parametrize("world", WORLDS)
def test_min_reduce_hits_first_minimum_wins(ranks, world, eight_device_mesh):
    ts = ranks[world][0]["ts"]  # (world, 64), ties and misses on purpose
    want_t = ts.min(axis=0)
    want_who = np.argmin(ts, axis=0)  # the first minimum: the lowest shard
    for res in ranks[world]:
        np.testing.assert_array_equal(res["t_min"], want_t)
        np.testing.assert_array_equal(res["who"], want_who)
    payload = np.repeat(np.arange(world, dtype=np.int32), 64).reshape(world, 64)

    def body(t, p):
        return jax_coll.min_reduce_hits(t[0], p[0], "rays")

    mesh = jax_make_mesh(world, ("rays",))
    jt, jp = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("rays"), P("rays")),
                                   out_specs=(P(), P()), check_vma=False))(
        jnp.asarray(ts), jnp.asarray(payload))
    np.testing.assert_array_equal(np.asarray(jt), want_t)
    np.testing.assert_array_equal(np.asarray(jp), want_who)


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_from_rank0(ranks, world):
    for res in ranks[world]:
        np.testing.assert_array_equal(res["broadcast"], np.ones((2,), np.float32))
