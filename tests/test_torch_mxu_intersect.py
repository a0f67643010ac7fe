"""The all-pairs hit as six matrix products (ops/intersect.py
`mxu_intersect_all_pairs`, `_dual_basis`), against the JAX package's
(tests/test_intersect.py:84 holds JAX's form to its Cramer solve).

* The dual basis equals JAX's to rtol 1e-12 in float64 (the same
  elementwise ops; torch's and XLA's CPU reciprocal agree).
* On random triangles and rays, in float64: hit and tri_id equal to
  JAX's form and to the port's Cramer `intersect_brute`, t to rtol 1e-5
  (the JAX test's tolerance), any_pass equal to JAX's form.  The matrix
  products sum their three terms in the BLAS's order, not XLA's, so t is
  not held bitwise.
* In float32: the topology agrees with JAX's form on all but boundary
  pairs (under 1% of rays), t to rtol 1e-4 where both hit the same
  triangle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.core.rays import RayBatch as JaxRayBatch  # noqa: E402
from ray_tracer_tpu.ops import intersect as jax_intersect  # noqa: E402
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.ops import intersect  # noqa: E402


def _random_scene(seed, r=257, f=129):
    g = np.random.default_rng(seed)
    v0 = g.normal(size=(f, 3)).astype(np.float32)
    v1 = v0 + g.normal(scale=0.5, size=(f, 3)).astype(np.float32)
    v2 = v0 + g.normal(scale=0.5, size=(f, 3)).astype(np.float32)
    orig = g.normal(scale=3.0, size=(r, 3)).astype(np.float32)
    dirn = g.normal(size=(r, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    return v0, v1, v2, orig, dirn


def _both(seed, dtype, t_lower):
    v0, v1, v2, orig, dirn = _random_scene(seed)
    tv = [torch.from_numpy(x) for x in (v0, v1, v2)]
    got = intersect.mxu_intersect_all_pairs(
        RayBatch.make(torch.from_numpy(orig), torch.from_numpy(dirn)), *tv, t_lower=t_lower,
        dtype={"float64": torch.float64, "float32": torch.float32}[dtype])
    want = jax_intersect.mxu_intersect_all_pairs(
        JaxRayBatch.make(jnp.asarray(orig), jnp.asarray(dirn)),
        *(jnp.asarray(x) for x in (v0, v1, v2)), t_lower=t_lower, dtype=jnp.dtype(dtype))
    return (v0, v1, v2, orig, dirn), got, want


def test_dual_basis_vs_jax():
    v0, v1, v2, _, _ = _random_scene(3)
    got = intersect._dual_basis(*(torch.from_numpy(x) for x in (v0, v1, v2)), torch.float64)
    want = jax_intersect._dual_basis(*(jnp.asarray(x) for x in (v0, v1, v2)), jnp.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed,t_lower", [(7, 1e-4), (11, None)])
def test_mxu_form_f64_vs_jax_and_cramer(seed, t_lower):
    (v0, v1, v2, orig, dirn), got, want = _both(seed, "float64", t_lower)
    hit, jhit = got.hit.numpy(), np.asarray(want.hit)
    np.testing.assert_array_equal(hit, jhit)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got.tri_id.numpy()[hit], np.asarray(want.tri_id)[hit])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5)
    np.testing.assert_array_equal(got.any_pass.numpy(), np.asarray(want.any_pass))
    assert got.t.dtype == torch.float32 and got.tri_id.dtype == torch.int32
    cramer = intersect.intersect_brute(
        RayBatch.make(torch.from_numpy(orig).double(), torch.from_numpy(dirn).double()),
        *(torch.from_numpy(x) for x in (v0, v1, v2)), t_lower=t_lower,
        det_dtype=torch.float64)
    np.testing.assert_array_equal(cramer.hit.numpy(), hit)
    np.testing.assert_array_equal(cramer.tri_id.numpy()[hit], got.tri_id.numpy()[hit])
    np.testing.assert_allclose(cramer.t.numpy()[hit], got.t.numpy()[hit], rtol=1e-5)


def test_mxu_form_f32_vs_jax():
    _, got, want = _both(5, "float32", 1e-4)
    same_hit = got.hit.numpy() == np.asarray(want.hit)
    same_tri = got.tri_id.numpy() == np.asarray(want.tri_id)
    agree = same_hit & (same_tri | ~got.hit.numpy())
    assert agree.mean() > 0.99, agree.mean()
    both = got.hit.numpy() & np.asarray(want.hit) & same_tri
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(want.t)[both], rtol=1e-4)
