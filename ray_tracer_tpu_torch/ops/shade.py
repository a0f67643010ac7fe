"""Blinn-Phong shading stages over (R,) hit batches.

Counterpart of `ray_tracer_tpu/ops/shade.py`:

  * `shade_serial` — Serial/raytracer.cpp:81-117: single implicit
    material, UNNORMALIZED geometric normal (v0-v1) x (v2-v0)
    (Serial/geometry.h:234-240), half-vector v + l left unnormalized,
    light intensity on diffuse+specular only, shadow scaling
    (spec+diff) before the ambient term is added.
  * `shade_parallel` — Parallel/raytracer.cu:468-506: per-hit material
    table, normal (v2-v1) x (v0-v1) (Parallel/geometry.cuh:160),
    normalized half-vector, shadow scaling the whole local color.

Plain elementwise tensor code, one op at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.models.materials import MaterialTable


def apply_shadow(color: torch.Tensor, shadow: torch.Tensor, scale: float) -> torch.Tensor:
    """Shadow attenuation: color * scale where the bool mask is set
    (the reference's exact branch)."""
    if shadow.dtype != torch.bool:
        raise NotImplementedError("soft (float) visibility is not ported yet")
    return torch.where(shadow[:, None], color * scale, color)


def _pow_safe(base: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """C pow() for base >= 0 (0^a = 0 for a > 0, 0^0 = 1), with the base
    guarded where it is not positive."""
    pos = base > 0
    safe = torch.where(pos, base, torch.ones_like(base))
    zero_pow = torch.where(exponent == 0, torch.ones_like(exponent),
                           torch.zeros_like(exponent))
    return torch.where(pos, torch.pow(safe, exponent), zero_pow)


class HitGeometry(NamedTuple):
    poi: torch.Tensor  # (R,3) point of intersection
    normal: torch.Tensor  # (R,3) geometric normal (unnormalized, as reference)
    view_dir: torch.Tensor  # (R,3) normalized direction toward the eye


def hit_geometry_serial(orig, dirn, t, tv0, tv1, tv2) -> HitGeometry:
    poi = orig + dirn * t[:, None]
    normal = vm.cross(tv0 - tv1, tv2 - tv0)  # getNormalMod, geometry.h:234-240
    return HitGeometry(poi=poi, normal=normal, view_dir=vm.normalize(-dirn))


def hit_geometry_parallel(orig, dirn, t, tv0, tv1, tv2) -> HitGeometry:
    poi = orig + dirn * t[:, None]
    normal = vm.cross(tv2 - tv1, tv0 - tv1)  # geometry.cuh:160
    return HitGeometry(poi=poi, normal=normal, view_dir=vm.normalize(-dirn))


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with NaN kept, as jnp.maximum(0.0, x)."""
    return torch.maximum(torch.zeros_like(x), x)


def shade_direct_serial(geom: HitGeometry, mat: MaterialTable,
                        light_pos: torch.Tensor,
                        light_intensity: torch.Tensor) -> torch.Tensor:
    """One light's diffuse+specular term, serial-variant conventions (no
    ambient)."""
    base = mat.base_color
    l = vm.normalize(light_pos - geom.poi)
    h = geom.view_dir + l  # NOT normalized (raytracer.cpp:95)
    n = geom.normal

    n_dot_l = _relu(vm.dot(n, l))
    n_dot_h = _relu(vm.dot(n, h))
    diffuse = base * (mat.kd * n_dot_l)[:, None] * light_intensity
    specular = base * (mat.ks * _pow_safe(n_dot_h, mat.spec_alpha))[:, None] * light_intensity
    return specular + diffuse


def shade_serial(geom: HitGeometry, mat: MaterialTable, light_pos, light_intensity,
                 in_shadow: torch.Tensor, shadow_scale: float) -> torch.Tensor:
    color = shade_direct_serial(geom, mat, light_pos, light_intensity)
    color = apply_shadow(color, in_shadow, shadow_scale)
    return color + mat.base_color * mat.ka[:, None]


def shade_direct_parallel(geom: HitGeometry, mat: MaterialTable,
                          light_pos: torch.Tensor) -> torch.Tensor:
    """One light's diffuse+specular term, parallel-variant conventions (no
    ambient, no light-intensity scalar)."""
    base = mat.base_color
    l = vm.normalize(light_pos - geom.poi)
    h = vm.normalize(geom.view_dir + l)  # normalized (raytracer.cu:478)
    n = geom.normal

    n_dot_l = _relu(vm.dot(n, l))
    n_dot_h = _relu(vm.dot(n, h))
    diffuse = base * n_dot_l[:, None] * mat.kd[:, None]
    specular = base * _pow_safe(n_dot_h, mat.spec_alpha)[:, None] * mat.ks[:, None]
    return diffuse + specular


def shade_parallel(geom: HitGeometry, mat: MaterialTable, light_pos,
                   in_shadow: torch.Tensor, shadow_scale: float) -> torch.Tensor:
    color = (shade_direct_parallel(geom, mat, light_pos)
             + mat.base_color * mat.ka[:, None])
    return apply_shadow(color, in_shadow, shadow_scale)
