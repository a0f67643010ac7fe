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
  * `vertex_normals` and `interpolate_normal` — the smooth-normal mode
    (RenderConfig.normal_mode="smooth"): area-weighted vertex normals,
    Phong-interpolated at the hits;
  * `light_sample_offsets` — the area light's fixed sample set
    (RenderConfig.shadow_samples, light_radius);
  * `shade_direct_serial` and `shade_direct_parallel` — one light's term
    without ambient, which every extra point light adds.

Plain elementwise tensor code, one op at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.models.materials import MaterialTable


def apply_shadow(color: torch.Tensor, shadow: torch.Tensor, scale: float) -> torch.Tensor:
    """Shadow attenuation: a bool mask takes the reference's exact branch
    (color * scale where set); a float factor f in [0, 1] (soft
    visibility) blends continuously, color * (1 - f * (1 - scale))."""
    if shadow.dtype == torch.bool:
        return torch.where(shadow[:, None], color * scale, color)
    return color * (1.0 - shadow * (1.0 - scale))[:, None]


def _strided(x: torch.Tensor) -> torch.Tensor:
    """x's values as a view with an inner stride of 2."""
    return torch.stack([x, x], dim=-1)[..., 0]


def _pow(base: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """torch.pow, on the CPU over strided operands: PyTorch's CPU loop over
    contiguous ones takes a vectorized pow that misses glibc's powf (the
    JAX package's, XLA calling it) in the last bit on about 1.8% of
    inputs, while its element-by-element loop calls powf itself."""
    if base.device.type == "cpu":
        return torch.pow(_strided(base), _strided(exponent))
    return torch.pow(base, exponent)


def _pow_safe(base: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """C pow() for base >= 0 (0^a = 0 for a > 0, 0^0 = 1), with the base
    guarded where it is not positive."""
    pos = base > 0
    safe = torch.where(pos, base, torch.ones_like(base))
    zero_pow = torch.where(exponent == 0, torch.ones_like(exponent),
                           torch.zeros_like(exponent))
    return torch.where(pos, _pow(safe, exponent), zero_pow)


def _cross_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """vecmath.cross on float32 arrays, one rounding an op."""
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=-1)


def _face_normals(v0, v1, v2, serial: bool):
    """Each face's unnormalized normal in the shading variant's convention
    (serial: (v0-v1) x (v2-v0); parallel: (v2-v1) x (v0-v1))."""
    return vm.cross(v0 - v1, v2 - v0) if serial else vm.cross(v2 - v1, v0 - v1)


class _VertexNormals(torch.autograd.Function):
    """The numpy table forward; the backward is the transpose of the JAX
    package's scatter-add: the output gradient gathered by faces, then
    back through the face-normal cross product into verts (autograd over
    the same ops in torch, recomputed)."""

    @staticmethod
    def forward(ctx, verts, faces, serial):
        ctx.save_for_backward(verts, faces)
        ctx.serial = serial
        return _vertex_normals_np(verts, faces, serial)

    @staticmethod
    def backward(ctx, g):
        verts, faces = ctx.saved_tensors
        with torch.enable_grad():
            v = verts.detach().requires_grad_(True)
            fv = [vm.take(v, faces[:, k]) for k in range(3)]
            fn = _face_normals(*fv, ctx.serial)
            gf = vm.take(g, faces[:, 0]) + vm.take(g, faces[:, 1]) + vm.take(g, faces[:, 2])
            (gv,) = torch.autograd.grad(fn, v, gf)
        return gv, None, None


def _vertex_normals_np(verts: torch.Tensor, faces: torch.Tensor, serial: bool) -> torch.Tensor:
    v = verts.detach().cpu().numpy().astype(np.float32)
    f = faces.detach().cpu().numpy().astype(np.int64)
    fv0, fv1, fv2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    fn = _cross_np(fv0 - fv1, fv2 - fv0) if serial else _cross_np(fv2 - fv1, fv0 - fv1)
    vn = np.zeros_like(v)
    np.add.at(vn, f.ravel(), np.repeat(fn, 3, axis=0))
    return torch.from_numpy(vn).to(verts.device)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor, serial: bool) -> torch.Tensor:
    """Area-weighted vertex normals -> (V,3) on verts' device, UNNORMALIZED:
    each face's unnormalized normal, in the shading variant's convention
    (`_face_normals`), added to its three vertices.

    Built on the host, in numpy: the sum of a vertex's faces is taken in
    face order, corner by corner (np.add.at over faces.ravel()), the
    order of the JAX package's `.at[faces].add` on the CPU, which sets
    the bits.  (A scatter-add with atomics on the card would sum in
    another order from run to run.)  Differentiable in verts
    (`_VertexNormals`) when they require grad."""
    if verts.requires_grad and torch.is_grad_enabled():
        return _VertexNormals.apply(verts, faces, serial)
    return _vertex_normals_np(verts, faces, serial)


def interpolate_normal(vn: torch.Tensor, faces: torch.Tensor, tri: torch.Tensor,
                       beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Barycentric (Phong) normal interpolation at hits -> UNIT normals.
    The bounce loop rescales them by the facet normal's length, whose
    magnitude the shading constants of both variants are tuned to."""
    f = faces[tri]
    alpha = 1.0 - beta - gamma
    n = (alpha[:, None] * vm.take(vn, f[:, 0]) + beta[:, None] * vm.take(vn, f[:, 1])
         + gamma[:, None] * vm.take(vn, f[:, 2]))
    return vm.normalize(n)


def light_sample_offsets(n: int, radius: float) -> np.ndarray:
    """The spherical area light's fixed Fibonacci sample set -> (n, 3)
    float32 offsets around the light's centre, the same for every pixel
    (no random numbers: renders are reproducible).  Taken in float64 and
    rounded once.  n == 1 is the centre itself, the hard-shadow limit."""
    if n == 1:
        return np.zeros((1, 3), np.float32)
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (3.0 - np.sqrt(5.0)) * i  # golden-angle spiral
    return (radius * np.stack([
        np.cos(theta) * np.sin(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(phi),
    ], axis=1)).astype(np.float32)


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
