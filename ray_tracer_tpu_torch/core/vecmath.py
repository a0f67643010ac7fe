"""Batched 3-vector math on tensors of shape (..., 3).

Counterpart of `ray_tracer_tpu/core/vecmath.py`.  Every op is written as
separate single elementwise tensor ops (multiply, add, subtract, divide,
sqrt), in the JAX package's order: `dot` and `length2` add the three
products left to right, `cross` is explicit multiply-and-subtract, `det3`
expands as t1 - t2 + t3, `normalize` is 1/sqrt with the n2 > 0 guard.
No composite op (linalg.cross, sum over the 3-axis, addcmul, lerp,
einsum) and no rsqrt appears on this path: the composites' CUDA builds
contract a*b+c into FMAs, rsqrt is not correctly rounded, and the
byte-exact image depends on every rounding step standing alone.
"""

from __future__ import annotations

import numpy as np
import torch


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true IEEE division.  PyTorch's CUDA `x / python_scalar`
    multiplies by the scalar's reciprocal instead, which can differ by
    one ulp; a 0-d tensor on x's own device keeps the division (made by
    a fill, not copied from the host, so no synchronisation)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis: (...,3),(...,3)->(...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product (reference: Serial/geometry.h:36-42)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length2(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's CPU sqrt (float32 and
    float64) is a vectorized approximation that misses the IEEE root by
    one ulp on just under 1% of inputs; numpy's is IEEE, as CUDA's is."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize: zero vectors stay zero (Vec3::normalize's
    `if (nor2 > 0)` guard, Serial/geometry.h:23-30)."""
    n2 = length2(a)
    pos = n2 > 0
    one = torch.ones_like(n2)
    inv = torch.where(pos, one / sqrt(torch.where(pos, n2, one)),
                      torch.zeros_like(n2))
    return a * inv[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection I - 2(I.N)N (reference: Parallel/raytracer.cu:875-878)."""
    return incident - normal * (2.0 * dot(incident, normal))[..., None]


def det3(a1, a2, a3, b1, b2, b3, c1, c2, c3):
    """3x3 determinant with the reference's expansion order t1 - t2 + t3
    (Serial/raytracer.cpp:203-211)."""
    t1 = a1 * (b2 * c3 - b3 * c2)
    t2 = a2 * (b1 * c3 - b3 * c1)
    t3 = a3 * (b1 * c2 - b2 * c1)
    return t1 - t2 + t3
