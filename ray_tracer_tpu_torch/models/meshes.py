"""Procedural mesh generators (numpy, host side).

The port's own copy of the generators the gradcheck scene uses, from
`ray_tracer_tpu/models/meshes.py`: `make_plane` (the reference asset
generator's ground plane) and `make_uv_sphere`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ray_tracer_tpu_torch.io.obj import MeshArrays


def make_plane(extent: float = 10.0, y: float = -1.0, density: int = 10) -> MeshArrays:
    """Ground plane mesh: (density*extent)^2 squares, 2 tris each."""
    n = int(round(extent * density))  # squares per side
    half = extent / 2.0
    xs = -half + np.arange(n + 1, dtype=np.float64) / density
    zs = -half + np.arange(n + 1, dtype=np.float64) / density
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, y), gz], axis=-1).reshape(-1, 3)

    # vertex (i,j) has linear index i*(n+1)+j
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (i * (n + 1) + j).ravel()
    v01 = (i * (n + 1) + j + 1).ravel()
    v10 = ((i + 1) * (n + 1) + j).ravel()
    v11 = ((i + 1) * (n + 1) + j + 1).ravel()
    tri_a = np.stack([v00, v01, v11], axis=-1)
    tri_b = np.stack([v00, v11, v10], axis=-1)
    faces = np.concatenate([tri_a, tri_b], axis=0).astype(np.int32)

    uvs = np.zeros((1, 2), dtype=np.float32)
    uv_faces = np.zeros_like(faces)
    return MeshArrays(verts.astype(np.float32), faces, uvs, uv_faces)


def make_uv_sphere(
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    radius: float = 1.0,
    n_lat: int = 16,
    n_lon: int = 32,
) -> MeshArrays:
    """UV-parameterised sphere (the gradcheck scene's spheres)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius + np.asarray(center)

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            jn = (j + 1) % n_lon
            a = i * n_lon + j
            b = i * n_lon + jn
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + jn
            if i > 0:
                faces.append((a, b, d))
            if i < n_lat - 1:
                faces.append((a, d, c))
    faces = np.asarray(faces, dtype=np.int32)
    uvs = np.zeros((1, 2), dtype=np.float32)
    return MeshArrays(verts.astype(np.float32), faces, uvs, np.zeros_like(faces))
