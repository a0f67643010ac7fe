"""Ray-triangle intersection: the reference's Cramer solve.

Counterpart of `ray_tracer_tpu/ops/intersect.py` (`cramer_tbg`,
`cramer_t_safe`, `cramer_bg_safe`, `_safe_cramer_columns`, `barycentric_pass`,
`intersect_brute`, and the matrix-product form `_dual_basis` and
`mxu_intersect_all_pairs`).  Every determinant is `vecmath.det3` in the
reference's expansion order (Serial/raytracer.cpp:203-211), each
numerator divided by the determinant A, over any broadcastable batch of
(ray, triangle) pairs.  With det_dtype=float64 it reproduces the
oracle's double-precision solve.  The acceptance test is the strict
beta > 0, gamma > 0, beta + gamma < 1 (Serial/geometry.h:162).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch


def _columns(o, d, a, b, c):
    """The three Cramer columns e1 = v0 - v1, e2 = v0 - v2, s = v0 - orig."""
    return a - b, a - c, a - o


def _det_a(e1, e2, d):
    return vm.det3(
        e1[..., 0], e2[..., 0], d[..., 0],
        e1[..., 1], e2[..., 1], d[..., 1],
        e1[..., 2], e2[..., 2], d[..., 2],
    )


def _det_t(e1, e2, s):
    return vm.det3(
        e1[..., 0], e2[..., 0], s[..., 0],
        e1[..., 1], e2[..., 1], s[..., 1],
        e1[..., 2], e2[..., 2], s[..., 2],
    )


def _det_beta(e2, s, d):
    return vm.det3(
        s[..., 0], e2[..., 0], d[..., 0],
        s[..., 1], e2[..., 1], d[..., 1],
        s[..., 2], e2[..., 2], d[..., 2],
    )


def _det_gamma(e1, s, d):
    return vm.det3(
        e1[..., 0], s[..., 0], d[..., 0],
        e1[..., 1], s[..., 1], d[..., 1],
        e1[..., 2], s[..., 2], d[..., 2],
    )


def cramer_tbg(orig, dirn, v0, v1, v2, det_dtype=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve orig + t*dir = v0 + beta*(v1-v0) + gamma*(v2-v0) by Cramer.

    Inputs broadcast over leading dims with trailing dim 3.  Returns
    (t, beta, gamma) in det_dtype.  A zero determinant gives inf/nan,
    which the strict comparisons downstream reject, as in the reference."""
    o, d, a, b, c = (x.to(det_dtype) for x in (orig, dirn, v0, v1, v2))
    e1, e2, s = _columns(o, d, a, b, c)
    A = _det_a(e1, e2, d)
    return _det_t(e1, e2, s) / A, _det_beta(e2, s, d) / A, _det_gamma(e1, s, d) / A


def _safe_cramer_columns(orig, dirn, v0, v1, v2, valid, det_dtype):
    """Sanitized columns and guarded divisor: (e1, e2, s, d, A_safe, guard).
    Invalid lanes get orig 0 and dir 1 before any arithmetic."""
    vmask = valid[..., None]
    o = torch.where(vmask, orig, torch.zeros_like(orig)).to(det_dtype)
    d = torch.where(vmask, dirn, torch.ones_like(dirn)).to(det_dtype)
    a, b, c = (x.to(det_dtype) for x in (v0, v1, v2))
    e1, e2, s = _columns(o, d, a, b, c)
    A = _det_a(e1, e2, d)
    guard = valid & (A != 0)
    A_safe = torch.where(guard, A, torch.ones_like(A))
    return e1, e2, s, d, A_safe, guard


def cramer_t_safe(orig, dirn, v0, v1, v2, valid, det_dtype=torch.float32
                  ) -> torch.Tensor:
    """Hit distance t only, with the divisor guarded on invalid lanes.
    On valid lanes bit-identical to `cramer_tbg`'s t."""
    e1, e2, s, d, A_safe, guard = _safe_cramer_columns(
        orig, dirn, v0, v1, v2, valid, det_dtype
    )
    tn = _det_t(e1, e2, s)
    return torch.where(guard, tn, torch.zeros_like(tn)) / A_safe


def cramer_bg_safe(orig, dirn, v0, v1, v2, valid, det_dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beta, gamma) only, with the inputs sanitized on invalid lanes as in
    `cramer_t_safe` (the same columns and guard): the hit barycentrics
    that textures and smooth normals read."""
    e1, e2, s, d, A_safe, guard = _safe_cramer_columns(
        orig, dirn, v0, v1, v2, valid, det_dtype
    )
    bn, gn = _det_beta(e2, s, d), _det_gamma(e1, s, d)
    return (torch.where(guard, bn, torch.zeros_like(bn)) / A_safe,
            torch.where(guard, gn, torch.zeros_like(gn)) / A_safe)


def barycentric_pass(beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """The reference's acceptance predicate (Serial/geometry.h:162)."""
    return (beta > 0) & (gamma > 0) & (beta + gamma < 1)


class BruteResult(NamedTuple):
    any_pass: torch.Tensor  # (R,) bool: any barycentric pass at all
    t: torch.Tensor  # (R,) nearest accepted t (f32)
    tri_id: torch.Tensor  # (R,) i32 argmin triangle (valid iff hit)
    hit: torch.Tensor  # (R,) bool: a nearest hit was recorded


def intersect_brute(
    rays: RayBatch,
    v0: torch.Tensor,
    v1: torch.Tensor,
    v2: torch.Tensor,
    t_lower: Optional[float] = None,
    det_dtype=torch.float32,
) -> BruteResult:
    """All-pairs nearest hit over (R rays x F tris), with cramer_tbg's
    arithmetic.  t_lower=None accepts any t (the serial reference's
    unrestricted update, Serial/geometry.h:164-171); t_lower=eps is the
    CUDA variant's t > eps gate.

    The triangles are swept in chunks so that memory stays bounded; the
    strict `<` fold across chunks keeps the argmin's lowest-index tie
    rule."""
    r, f = rays.count, v0.shape[0]
    dev = rays.orig.device
    best_t = torch.full((r,), float("inf"), dtype=det_dtype, device=dev)
    best_id = torch.zeros((r,), dtype=torch.int64, device=dev)
    any_pass = torch.zeros((r,), dtype=torch.bool, device=dev)
    chunk = max(1, (1 << 22) // max(r, 1))
    o, d = rays.orig[:, None, :], rays.dirn[:, None, :]
    for lo in range(0, f, chunk):
        hi = min(f, lo + chunk)
        t, beta, gamma = cramer_tbg(o, d, v0[None, lo:hi], v1[None, lo:hi],
                                    v2[None, lo:hi], det_dtype=det_dtype)
        passed = barycentric_pass(beta, gamma)
        accept = passed if t_lower is None else passed & (t > t_lower)
        any_pass |= passed.any(dim=1)
        t_masked = torch.where(accept, t, torch.full_like(t, float("inf")))
        j = torch.argmin(t_masked, dim=1)
        m = torch.gather(t_masked, 1, j[:, None])[:, 0]
        upd = m < best_t
        best_t = torch.where(upd, m, best_t)
        best_id = torch.where(upd, j + lo, best_id)
    return BruteResult(
        any_pass=any_pass,
        t=best_t.to(torch.float32),
        tri_id=best_id.to(torch.int32),
        hit=torch.isfinite(best_t),
    )


def _dual_basis(v0, v1, v2, dtype):
    """Per-triangle plane normal and barycentric dual vectors
    (ray_tracer_tpu/ops/intersect.py:212):

    n  = e1 x e2 (e1 = v1-v0, e2 = v2-v0)
    b1 = (e2 x n) / |n|^2   so that (p - v0).b1 = beta
    b2 = (n x e1) / |n|^2   so that (p - v0).b2 = gamma
    """
    a, b, c = (x.to(dtype) for x in (v0, v1, v2))
    e1 = b - a
    e2 = c - a
    n = vm.cross(e1, e2)
    inv_n2 = 1.0 / vm.dot(n, n)
    b1 = vm.cross(e2, n) * inv_n2[..., None]
    b2 = vm.cross(n, e1) * inv_n2[..., None]
    return n, b1, b2


def mxu_intersect_all_pairs(
    rays: RayBatch,
    v0: torch.Tensor,
    v1: torch.Tensor,
    v2: torch.Tensor,
    t_lower: Optional[float] = None,
    dtype=torch.float32,
) -> BruteResult:
    """All-pairs nearest hit as six (R,3)x(3,T) matrix products
    (ray_tracer_tpu/ops/intersect.py:229): t from the plane equation, beta
    and gamma from the dual vectors.  Algebraically `intersect_brute`, not
    bitwise it (another order of operations): topology agrees, t to a
    tolerance.  The JAX package left the products to XLA and no render
    path calls it; here they are `torch.matmul` (full float32 on the card:
    TF32 is off by default).  Memory is several (R, T) matrices of
    `dtype`: callers cut R to fit."""
    n, b1, b2 = _dual_basis(v0, v1, v2, dtype)
    o = rays.orig.to(dtype)
    d = rays.dirn.to(dtype)
    a = v0.to(dtype)

    dn = torch.matmul(d, n.T)  # (R, T)
    on = torch.matmul(o, n.T)
    v0n = vm.dot(a, n)  # (T,)
    t = (v0n[None, :] - on) / dn

    ob1 = torch.matmul(o, b1.T)
    db1 = torch.matmul(d, b1.T)
    v0b1 = vm.dot(a, b1)
    beta = ob1 + t * db1 - v0b1[None, :]

    ob2 = torch.matmul(o, b2.T)
    db2 = torch.matmul(d, b2.T)
    v0b2 = vm.dot(a, b2)
    gamma = ob2 + t * db2 - v0b2[None, :]

    passed = barycentric_pass(beta, gamma)
    accept = passed if t_lower is None else passed & (t > t_lower)
    t_masked = torch.where(accept, t, torch.full_like(t, float("inf")))
    tri_id = torch.argmin(t_masked, dim=1)
    t_best = torch.gather(t_masked, 1, tri_id[:, None])[:, 0]
    return BruteResult(
        any_pass=passed.any(dim=1),
        t=t_best.to(torch.float32),
        tri_id=tri_id.to(torch.int32),
        hit=torch.isfinite(t_best),
    )
