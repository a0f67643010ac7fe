"""Wavefront OBJ loading into flat numpy arrays.

The port's own copy of the numpy parser of `ray_tracer_tpu/io/obj.py`
(`_parse_obj_numpy`, `load_obj`): the same OBJ subset (`v`, `vt`,
`f v/vt v/vt v/vt`), 1-based and negative indices, and the per-mesh
transform scale * (coord + offset) taken in float64 before narrowing to
float32.  The port does not bind the native C++ loader; this parser is
the one the JAX package's tests pin equal to it.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np


class MeshArrays(NamedTuple):
    verts: np.ndarray  # (V,3) float32
    faces: np.ndarray  # (F,3) int32, 0-based
    uvs: np.ndarray  # (VT,2) float32 (may be empty)
    uv_faces: np.ndarray  # (F,3) int32, 0-based (may be empty)

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


def _parse_obj_numpy(path: str) -> MeshArrays:
    verts = []
    uvs = []
    faces = []
    uv_faces = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append((float(parts[1]), float(parts[2])))
            elif line.startswith("f "):
                parts = line.split()[1:4]
                vi = []
                ti = []
                uv_ok = True
                for p in parts:
                    comps = p.split("/")
                    iv = int(comps[0])
                    # negative indices count back from the elements
                    # defined so far; stored 1-based like positive ones
                    vi.append(iv if iv > 0 else len(verts) + iv + 1)
                    if len(comps) > 1 and comps[1]:
                        it = int(comps[1])
                        if it == 0:
                            uv_ok = False  # invalid vt index: untextured face
                        else:
                            ti.append(it if it > 0 else len(uvs) + it + 1)
                faces.append(vi)
                # one row per face keeps uv_faces aligned with faces
                # (0 here becomes -1, "no uv", after the shift below)
                uv_faces.append(ti if (uv_ok and len(ti) == 3) else [0, 0, 0])
    v = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    f = np.asarray(faces, dtype=np.int32).reshape(-1, 3) - 1
    vt = np.asarray(uvs, dtype=np.float32).reshape(-1, 2)
    fvt = np.asarray(uv_faces, dtype=np.int32).reshape(-1, 3) - 1
    if fvt.size == 0 or (fvt < 0).all():
        # untextured mesh: drop both tables
        vt = np.zeros((0, 2), dtype=np.float32)
        fvt = np.zeros((0, 3), dtype=np.int32)
    return MeshArrays(v, f, vt, fvt)


def load_obj(
    path: str,
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    scale: float = 1.0,
) -> MeshArrays:
    """Load an OBJ; vertices become scale * (coord + offset), computed in
    float64 and then cast to float32 (Parallel/raytracer.cu:824)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    mesh = _parse_obj_numpy(path)
    off = np.asarray(offset, dtype=np.float64)
    v = (float(scale) * (mesh.verts.astype(np.float64) + off)).astype(np.float32)
    return MeshArrays(v, mesh.faces, mesh.uvs, mesh.uv_faces)
