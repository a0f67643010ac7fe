"""Kernel A's plain version against the JAX package's Pallas all-pairs
kernel, run in interpret mode on the CPU as tests/test_pallas.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.core.rays import RayBatch as JaxRays  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.ops.camera import camera_rays as jax_camera_rays  # noqa: E402
from ray_tracer_tpu.ops.pallas_intersect import intersect_brute_pallas  # noqa: E402
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops.brute_intersect import (  # noqa: E402
    brute_intersect_plain,
    intersect_brute_kernel,
    triangle_table,
)


@pytest.fixture(scope="module")
def gradcheck16():
    jscene, jcfg = jax_scenes.gradcheck_scene(16, 16)
    tscene, _ = scenes.gradcheck_scene(16, 16, device="cpu")
    rays = jax_camera_rays(jcfg.camera)  # 256 rays = one Pallas tile
    return jscene, tscene, rays


@pytest.mark.parametrize("t_lower", [0.0, 1e-4, 4.0])
def test_plain_matches_pallas_kernel(gradcheck16, t_lower):
    """hit and tri_id equal; t to rtol 1e-5, since the Pallas side is
    jitted and XLA fuses its f32 arithmetic differently from the port's
    one-op-at-a-time evaluation (the two differ in the last bits)."""
    jscene, tscene, rays = gradcheck16
    want = intersect_brute_pallas(rays, *jscene.triangle_soa(), t_lower=t_lower)
    trays = RayBatch(*(torch.from_numpy(np.array(x)) for x in rays))
    got = intersect_brute_kernel(trays, *tscene.triangle_soa(), t_lower=t_lower)
    h = np.asarray(want.hit)
    assert h.any()
    np.testing.assert_array_equal(got.hit.numpy(), h)
    np.testing.assert_array_equal(got.any_pass.numpy(), np.asarray(want.any_pass))
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(want.t)[h], rtol=1e-5)
    assert np.isinf(got.t.numpy()[~h]).all()


def test_padding_lanes_never_hit(gradcheck16):
    """Rays with +inf origins (the padding and retired-lane convention) and
    zero (degenerate) triangles never hit, on either side."""
    jscene, tscene, _ = gradcheck16
    jrays = JaxRays.make(jnp.full((3, 3), jnp.inf), jnp.ones((3, 3)))
    assert not np.asarray(
        intersect_brute_pallas(jrays, *jscene.triangle_soa(), t_lower=1e-4).hit).any()
    trays = RayBatch.make(torch.full((3, 3), float("inf")), torch.ones((3, 3)))
    assert not intersect_brute_kernel(trays, *tscene.triangle_soa(), t_lower=1e-4).hit.any()
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(4, 3).contiguous()
    t, tid = brute_intersect_plain(o, d, torch.zeros((9, 5)), 0.0)
    assert torch.isinf(t).all() and (tid == -1).all()


@pytest.mark.parametrize("pairs_per_chunk", [2, 1 << 22])
def test_chunking_keeps_lowest_index_ties(monkeypatch, pairs_per_chunk):
    """Duplicate triangles give equal t: the lowest index wins, across the
    triangle chunks of the plain sweep as within one."""
    from ray_tracer_tpu_torch.ops import brute_intersect

    monkeypatch.setattr(brute_intersect, "PAIRS_PER_CHUNK_CPU", pairs_per_chunk)
    v = torch.tensor([[0.0, -1.0, -1.0], [0.0, 1.0, -1.0], [0.0, 0.0, 1.0]])
    tri = torch.cat([v.reshape(1, 9)] * 7)  # 7 identical triangles (F, 9)
    tri[0] += 10.0  # the first one is out of the way
    v0, v1, v2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    rays = RayBatch.make(torch.tensor([[-2.0, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]]))
    res = intersect_brute_kernel(rays, v0, v1, v2, tri9=triangle_table(v0, v1, v2))
    assert res.hit.item() and res.tri_id.item() == 1 and res.t.item() == 2.0
