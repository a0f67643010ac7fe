"""Uniform-grid acceleration structure: vectorized two-pass CSR build.

The port's counterpart of `ray_tracer_tpu/accel/grid.py` (`grid_resolution`,
`build_grid`), which reproduces the reference's GridAccel construction
(Serial/grid.h:79-153):

  * nVoxels = clamp(int(delta * 3*cbrt(F)/maxExtent + 1), 1, 64) per
    axis, in float32 like the reference (grid.h:94-101);
  * a triangle enters every voxel its AABB overlaps (grid.h:118-150), or
    with `exact_overlap` only those an exact SAT test keeps;
  * z-major voxel index z*nx*ny + y*nx + x (grid.h:73-75), triangles in
    ascending order within a voxel.

The port binds nothing of the JAX package's native C++ builder: the
binning runs on the grid's device through `accel/native.bin_triangles`,
kernel H on the card and its plain version (the JAX package's numpy
`_build_csr_numpy` and `tri_box_overlap`, on tensors) on the CPU.  The
resolution and the float32 frame stay host numpy.  The CSR arrays live on
the device as int32 tensors; `GridHost` keeps numpy copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ray_tracer_tpu_torch.accel.native import bin_triangles
from ray_tracer_tpu_torch.device import resolve_device
from ray_tracer_tpu_torch.utils.timing import part


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


def build_grid(
    verts: np.ndarray,
    faces: np.ndarray,
    resolution_multiplier: float = 3.0,
    max_resolution: int = 64,
    exact_overlap: bool = False,
    device=None,
    force_resolution: "Tuple[int, int, int] | None" = None,
) -> UniformGrid:
    """Build the CSR grid on `device` (cuda unless "cpu" is asked for):
    the resolution and the float32 frame on the host as the reference
    computes them, the binning (float32 posToVoxel, the SAT test in
    float64 with `exact_overlap`) through `accel/native.bin_triangles`,
    kernel H on the card.  force_resolution replaces the 3*cbrt(F) rule
    with a fixed (nx, ny, nz): the per-shard grids of the ring share the
    replicated build's resolution (`parallel.shard.build_ring_grids`)."""
    dev = resolve_device(device)
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    num_tris = faces.shape[0]

    if num_tris == 0:
        lower = np.zeros((3,), np.float32)
        upper = np.zeros((3,), np.float32)
    else:
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        lower = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
        upper = np.maximum(np.maximum(v0, v1), v2).max(axis=0)

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
    verts_t, faces_t = torch.from_numpy(verts).to(dev), torch.from_numpy(faces).to(dev)

    nx, ny, nz = (int(x) for x in n_voxels)
    with part("H"):
        cell_start, tri_ids = bin_triangles(verts_t, faces_t, lower, inv_width, width,
                                            (nx, ny, nz), exact_overlap and num_tris > 0)
    with part("csr_to_host"):
        host = GridHost(lower=lower, upper=upper, width=width,
                        inv_width=inv_width, cell_start=cell_start.cpu().numpy(),
                        tri_ids=tri_ids.cpu().numpy())
    # the binned tensors stay on the device; the host keeps the copies
    with part("grid_assemble"):
        return _assemble(host, (nx, ny, nz), dev, cell_start.to(torch.int32), tri_ids)


def grid_from_numpy(host, n_voxels, device=None) -> UniformGrid:
    """Put a host grid on the device.  `host` is anything with the fields
    of `GridHost` (lower, upper, width, inv_width, cell_start, tri_ids) —
    this package's or the JAX package's — so two traversals can run on
    one grid."""
    dev = resolve_device(device)
    host = GridHost(*(np.asarray(getattr(host, f)) for f in GridHost._fields))

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    return _assemble(host, n_voxels, dev, i32(host.cell_start), i32(host.tri_ids))


def _assemble(host: GridHost, n_voxels, dev, cell_start: torch.Tensor,
              tri_ids: torch.Tensor) -> UniformGrid:
    """The grid from its host copy and its CSR already on `dev` as int32."""
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

    arrays = GridArrays(
        lower=f32(host.lower), upper=f32(host.upper), width=f32(host.width),
        inv_width=f32(host.inv_width), cell_start=cell_start, tri_ids=tri_ids,
    )
    return UniformGrid(arrays=arrays, meta=meta, host=host)
