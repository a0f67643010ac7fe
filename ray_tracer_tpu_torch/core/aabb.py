"""Axis-aligned bounding boxes (counterpart of `ray_tracer_tpu/core/aabb.py`)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ray_tracer_tpu_torch.core.rays import RayBatch


class AABB(NamedTuple):
    lower: torch.Tensor  # (3,)
    upper: torch.Tensor

    def inside(self, pt: torch.Tensor) -> torch.Tensor:
        """Inclusive containment test (geometry.h:287-289); (...,3)->(...)."""
        return torch.all((pt >= self.lower) & (pt <= self.upper), dim=-1)


def slab_intersect(
    box: AABB, rays: RayBatch
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB test (reference: Serial/geometry.h:291-315).
    Returns (hit, t0, t1).  1/dir is unguarded like the reference; the
    NaN-propagating minimum/maximum and the NaN-false compares reproduce
    its axis-parallel behaviour."""
    inv = 1.0 / rays.dirn
    t_near = (box.lower - rays.orig) * inv
    t_far = (box.upper - rays.orig) * inv
    lo = torch.minimum(t_near, t_far)
    hi = torch.maximum(t_near, t_far)

    t0, t1 = rays.mint, rays.maxt
    for axis in range(3):
        t0 = torch.where(lo[:, axis] > t0, lo[:, axis], t0)
        t1 = torch.where(hi[:, axis] < t1, hi[:, axis], t1)
    return t0 <= t1, t0, t1
