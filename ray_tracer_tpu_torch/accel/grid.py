"""Uniform-grid acceleration structure: vectorized two-pass CSR build.

The port's own copy of the numpy build of `ray_tracer_tpu/accel/grid.py`
(`grid_resolution`, `pos_to_voxel`, `tri_box_overlap`, `_build_csr_numpy`,
`build_grid`), which reproduces the reference's GridAccel construction
(Serial/grid.h:79-153):

  * nVoxels = clamp(int(delta * 3*cbrt(F)/maxExtent + 1), 1, 64) per
    axis, in float32 like the reference (grid.h:94-101);
  * a triangle enters every voxel its AABB overlaps (grid.h:118-150), or
    with `exact_overlap` only those an exact SAT test keeps;
  * z-major voxel index z*nx*ny + y*nx + x (grid.h:73-75), triangles in
    ascending order within a voxel.

The port does not bind the native C++ builder; this is the numpy build
the JAX package's tests pin equal to it.  The CSR arrays go to the device
as int32 tensors; `GridHost` keeps the numpy originals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ray_tracer_tpu_torch.device import resolve_device


class GridMeta(NamedTuple):
    n_voxels: Tuple[int, int, int]
    max_per_voxel: int
    nnz: int

    @property
    def total_voxels(self) -> int:
        nx, ny, nz = self.n_voxels
        return nx * ny * nz


class GridArrays(NamedTuple):
    """Device-resident grid data."""

    lower: torch.Tensor  # (3,) f32 scene AABB
    upper: torch.Tensor  # (3,)
    width: torch.Tensor  # (3,) voxel widths
    inv_width: torch.Tensor  # (3,) 0 where width == 0
    cell_start: torch.Tensor  # (nx*ny*nz + 1,) i32 CSR offsets
    tri_ids: torch.Tensor  # (nnz,) i32


class GridHost(NamedTuple):
    """Host (numpy) copy of the grid."""

    lower: np.ndarray
    upper: np.ndarray
    width: np.ndarray
    inv_width: np.ndarray
    cell_start: np.ndarray
    tri_ids: np.ndarray


@dataclass(frozen=True)
class UniformGrid:
    arrays: GridArrays
    meta: GridMeta
    host: GridHost


def _max_axis(delta: np.ndarray) -> int:
    """Reference maxAxis comparison chain (Serial/geometry.h:276-285)."""
    axis = 0 if delta[0] > delta[1] else 1
    if axis == 1:
        return 1 if delta[1] > delta[2] else 2
    return 0 if delta[0] > delta[2] else 2


def grid_resolution(
    lower: np.ndarray,
    upper: np.ndarray,
    num_tris: int,
    resolution_multiplier: float = 3.0,
    max_resolution: int = 64,
) -> np.ndarray:
    """nVoxels per axis with the reference's float32 arithmetic (grid.h:94-101)."""
    delta = (upper - lower).astype(np.float32)
    if delta[_max_axis(delta)] == 0.0:
        # fully degenerate mesh: a 1-cell grid instead of inf * 0 = NaN
        return np.ones((3,), np.int32)
    max_inv_width = np.float32(1.0) / delta[_max_axis(delta)]
    cube_root = np.float32(resolution_multiplier) * np.float32(
        np.power(np.float32(num_tris), np.float32(1.0 / 3.0))
    )
    vpud = cube_root * max_inv_width
    n = (delta * vpud + np.float32(1.0)).astype(np.int32)  # C truncation
    return np.clip(n, 1, max_resolution)


def pos_to_voxel(p: np.ndarray, lower: np.ndarray, inv_width: np.ndarray,
                 n_voxels: np.ndarray) -> np.ndarray:
    """posToVoxel with C int-cast truncation + clamp (grid.h:59-66).
    p: (...,3) -> (...,3) int32."""
    v = ((p - lower) * inv_width).astype(np.float32)
    v = np.trunc(v).astype(np.int32)
    return np.clip(v, 0, n_voxels - 1)


def tri_box_overlap(v0, v1, v2, box_lo, box_hi, pad) -> np.ndarray:
    """Vectorized SAT triangle/AABB overlap (Akenine-Möller 2001).

    All inputs (P, 3) float64; `pad` inflates the box half-extents so the
    test stays conservative against float32 rounding elsewhere.  The box
    axes are already tested by the caller (the candidates come from an
    AABB expansion), so this runs the triangle-plane axis and the 9
    edge-cross axes, with inclusive comparisons.  Returns (P,) bool."""
    c = (box_lo + box_hi) * 0.5
    h = (box_hi - box_lo) * 0.5 + pad
    u0, u1, u2 = v0 - c, v1 - c, v2 - c

    def sep(ax, ay, az):
        """True where the axis (ax, ay, az) separates box and triangle."""
        p0 = ax * u0[:, 0] + ay * u0[:, 1] + az * u0[:, 2]
        p1 = ax * u1[:, 0] + ay * u1[:, 1] + az * u1[:, 2]
        p2 = ax * u2[:, 0] + ay * u2[:, 1] + az * u2[:, 2]
        r = (h[:, 0] * np.abs(ax) + h[:, 1] * np.abs(ay)
             + h[:, 2] * np.abs(az))
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        return (lo > r) | (hi < -r)

    e0, e1, e2 = u1 - u0, u2 - u1, u0 - u2
    nx = e0[:, 1] * e1[:, 2] - e0[:, 2] * e1[:, 1]
    ny = e0[:, 2] * e1[:, 0] - e0[:, 0] * e1[:, 2]
    nz = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    separated = sep(nx, ny, nz)
    for e in (e0, e1, e2):
        ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
        zero = np.zeros_like(ex)
        separated |= sep(zero, -ez, ey)
        separated |= sep(ez, zero, -ex)
        separated |= sep(-ey, ex, zero)
    return ~separated


def _build_csr_numpy(tri_lo, tri_hi, lower, inv_width, n_voxels, nx, ny,
                     exact=None):
    """Expand each triangle into its overlapped voxel range, then
    stable-sort by cell (grid.h:135-148, same within-cell order).

    exact=(verts, faces, width): SAT-filter the candidate pairs; the
    survivors keep their within-cell order."""
    num_tris = tri_lo.shape[0]
    total = int(n_voxels[0]) * int(n_voxels[1]) * int(n_voxels[2])
    if num_tris == 0:
        return np.zeros(total + 1, dtype=np.int64), np.zeros(0, dtype=np.int32)

    vmin = pos_to_voxel(tri_lo, lower, inv_width, n_voxels)  # (F,3)
    vmax = pos_to_voxel(tri_hi, lower, inv_width, n_voxels)
    span = (vmax - vmin + 1).astype(np.int64)  # (F,3)
    per_tri = span[:, 0] * span[:, 1] * span[:, 2]
    starts = np.concatenate([[0], np.cumsum(per_tri)])
    total_entries = int(starts[-1])

    tri_of = np.repeat(np.arange(num_tris, dtype=np.int64), per_tri)
    within = np.arange(total_entries, dtype=np.int64) - starts[tri_of]

    syz = span[tri_of, 1] * span[tri_of, 2]
    dx = within // syz
    rem = within % syz
    dy = rem // span[tri_of, 2]
    dz = rem % span[tri_of, 2]

    x = vmin[tri_of, 0] + dx
    y = vmin[tri_of, 1] + dy
    z = vmin[tri_of, 2] + dz

    if exact is not None:
        verts, faces, width = exact
        # cell boxes in f64 from the f32 grid frame, padded so that the
        # f32 binning error and boundary-touching triangles stay covered
        lo64 = lower.astype(np.float64)
        w64 = width.astype(np.float64)
        idx = np.stack([x, y, z], axis=1).astype(np.float64)
        box_lo = lo64 + idx * w64
        box_hi = lo64 + (idx + 1.0) * w64
        pad = np.maximum(w64 * 1e-4, 1e-12)
        pad = np.broadcast_to(pad, box_lo.shape)
        f = faces[tri_of]
        keep = tri_box_overlap(
            verts[f[:, 0]].astype(np.float64),
            verts[f[:, 1]].astype(np.float64),
            verts[f[:, 2]].astype(np.float64),
            box_lo, box_hi, pad,
        )
        tri_of, x, y, z = tri_of[keep], x[keep], y[keep], z[keep]

    cell = z * (nx * ny) + y * nx + x  # z-major (grid.h:73-75)

    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    tri_ids = tri_of[order].astype(np.int32)

    counts = np.bincount(cell_sorted, minlength=total)
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return cell_start, tri_ids


def build_grid(
    verts: np.ndarray,
    faces: np.ndarray,
    resolution_multiplier: float = 3.0,
    max_resolution: int = 64,
    exact_overlap: bool = False,
    device=None,
    force_resolution: "Tuple[int, int, int] | None" = None,
) -> UniformGrid:
    """Build the CSR grid in numpy (float32 binning, as the reference) and
    put it on `device` (cuda unless "cpu" is asked for).  force_resolution
    replaces the 3*cbrt(F) rule with a fixed (nx, ny, nz): the per-shard
    grids of the ring share the replicated build's resolution
    (`parallel.shard.build_ring_grids`)."""
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    num_tris = faces.shape[0]

    if num_tris == 0:
        tri_lo = np.zeros((0, 3), np.float32)
        tri_hi = tri_lo
        lower = np.zeros((3,), np.float32)
        upper = np.zeros((3,), np.float32)
    else:
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        tri_lo = np.minimum(np.minimum(v0, v1), v2)
        tri_hi = np.maximum(np.maximum(v0, v1), v2)
        lower = tri_lo.min(axis=0)
        upper = tri_hi.max(axis=0)

    if force_resolution is not None:
        n_voxels = np.asarray(force_resolution, np.int32)
    else:
        n_voxels = grid_resolution(
            lower, upper, num_tris, resolution_multiplier, max_resolution
        )
    delta = (upper - lower).astype(np.float32)
    width = delta / n_voxels.astype(np.float32)
    with np.errstate(divide="ignore"):  # zero-extent axes
        inv_width = np.where(
            width == 0.0, np.float32(0.0), np.float32(1.0) / width
        )

    nx, ny, nz = (int(x) for x in n_voxels)
    cell_start, tri_ids = _build_csr_numpy(
        tri_lo, tri_hi, lower, inv_width, n_voxels, nx, ny,
        exact=(verts, faces, width) if exact_overlap and num_tris else None,
    )
    host = GridHost(lower=lower, upper=upper, width=width,
                    inv_width=inv_width, cell_start=cell_start,
                    tri_ids=tri_ids)
    return grid_from_numpy(host, (nx, ny, nz), device=device)


def grid_from_numpy(host, n_voxels, device=None) -> UniformGrid:
    """Put a host grid on the device.  `host` is anything with the fields
    of `GridHost` (lower, upper, width, inv_width, cell_start, tri_ids) —
    this package's or the JAX package's — so two traversals can run on
    one grid."""
    dev = resolve_device(device)
    host = GridHost(*(np.asarray(getattr(host, f)) for f in GridHost._fields))
    counts = np.diff(host.cell_start)
    nx, ny, nz = (int(n) for n in n_voxels)
    if host.cell_start.shape != (nx * ny * nz + 1,):
        raise ValueError("cell_start does not match n_voxels")
    meta = GridMeta(
        n_voxels=(nx, ny, nz),
        max_per_voxel=int(counts.max()) if counts.size else 0,
        nnz=int(host.tri_ids.shape[0]),
    )

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    arrays = GridArrays(
        lower=f32(host.lower), upper=f32(host.upper), width=f32(host.width),
        inv_width=f32(host.inv_width), cell_start=i32(host.cell_start),
        tri_ids=i32(host.tri_ids),
    )
    return UniformGrid(arrays=arrays, meta=meta, host=host)
