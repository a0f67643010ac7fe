"""Procedural mesh generators (numpy, host side).

The port's own copy of `ray_tracer_tpu/models/meshes.py`: `make_plane`,
`make_reference_plane` (the reference asset generator's ground plane,
quirks included), `make_uv_sphere`, `make_displaced_sphere` (the
nefertiti workload's stand-in mesh, numpy with a fixed seed) and
`write_obj`.  Each gives the JAX package's arrays byte for byte.
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


def make_reference_plane(squares_per_unit: int = 10) -> MeshArrays:
    """Exact reproduction of the reference's asset generator
    (plane_mesh_creator.py:1-81), including its quirks:

      * the float stepper runs one step PAST the far edge (`to_` is
        B.x + step with an inclusive bound), so the 10x10-unit plane at
        y=-1 gets 101x101 squares ([-5, 5.1] per axis), 10,404 deduped
        vertices and 20,402 faces — matching assets/plane.obj exactly;
      * slice coordinates are rounded to log10(squares_per_unit)
        decimals each iteration;
      * faces wind (A, C, B), (A, D, C) with one shared dummy uv.
    """
    from math import log10

    step = 1.0 / squares_per_unit
    nd = int(log10(squares_per_unit))
    lo, hi = -5.0, 5.0

    def stepper(from_, to_):
        vals = []
        while from_ <= to_:
            from_ = round(from_, nd)
            vals.append(from_)
            from_ += step
        return vals

    xs = [lo] + stepper(lo + step, hi + step)
    zs = [lo] + stepper(lo + step, hi + step)

    verts = []
    find = {}
    faces = []

    def vid(x, z):
        key = (x, z)
        if key not in find:
            find[key] = len(verts)
            verts.append((x, -1.0, z))
        return find[key]

    for i in range(1, len(xs)):
        x0, x1 = xs[i - 1], xs[i]
        for j in range(1, len(zs)):
            z0, z1 = zs[j - 1], zs[j]
            a = vid(x0, z0)
            b = vid(x1, z0)
            c = vid(x1, z1)
            dd = vid(x0, z1)
            faces.append((a, c, b))
            faces.append((a, dd, c))

    v = np.asarray(verts, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    uvs = np.zeros((1, 2), dtype=np.float32)
    return MeshArrays(v, f, uvs, np.zeros_like(f))


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


def make_displaced_sphere(
    n_lat: int = 256,
    n_lon: int = 512,
    radius: float = 1.0,
    displacement: float = 0.15,
    seed: int = 0,
) -> MeshArrays:
    """High-poly synthetic scan stand-in (~n_lat*n_lon*2 triangles).

    BASELINE configs 4-5 call for the reference's `nefertiti` mesh, which
    was stripped from the reference checkout; this generates a comparably
    sized bumpy closed surface (default ~260k faces) deterministically.
    """
    base = make_uv_sphere(radius=radius, n_lat=n_lat, n_lon=n_lon)
    rng = np.random.default_rng(seed)
    # Smooth pseudo-random radial displacement from a few spherical harmonics-ish
    # sinusoids so the surface is bumpy but not noisy.
    v = base.verts.astype(np.float64)
    d = np.zeros((v.shape[0], 1))
    for _ in range(6):
        k = rng.normal(size=3) * 4.0
        p = rng.uniform(0, 2 * np.pi)
        d += np.sin(v @ k.reshape(3, 1) + p)
    scale = 1.0 + displacement * d / 6.0
    verts = (v * scale).astype(np.float32)
    return MeshArrays(verts, base.faces, base.uvs, base.uv_faces)


def write_obj(path: str, mesh: MeshArrays) -> None:
    """Write a MeshArrays to OBJ (v / vt / f v/vt) for interop."""
    with open(path, "w") as fh:
        for v in mesh.verts:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        uvs = mesh.uvs if mesh.uvs.size else np.zeros((1, 2), dtype=np.float32)
        for t in uvs:
            fh.write(f"vt {t[0]} {t[1]}\n")
        uvf = mesh.uv_faces if mesh.uv_faces.size else np.zeros_like(mesh.faces)
        for f, tf in zip(mesh.faces, uvf):
            if tf[0] < 0:  # face without vt (partially-textured mesh)
                fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")
            else:
                fh.write(
                    f"f {f[0]+1}/{tf[0]+1} {f[1]+1}/{tf[1]+1} {f[2]+1}/{tf[2]+1}\n"
                )
