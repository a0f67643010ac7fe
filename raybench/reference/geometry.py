"""The reference's scene: OBJ meshes read with numpy, the upstream's
per-mesh transform, the material table and the light, from a
configuration file's entries (`raybench/configs/<name>.json`).

Plain numpy and torch; nothing of the program is imported.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_obj(path: str):
    """(verts (V,3) float64, faces (F,3) int64, 0-based) of a triangulated
    OBJ: `v x y z` and `f a[/..] b[/..] c[/..]` lines, 1-based or
    negative indices."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                x, y, z = line.split()[1:4]
                verts.append((float(x), float(y), float(z)))
            elif line.startswith("f "):
                ids = []
                for tok in line.split()[1:4]:
                    i = int(tok.split("/")[0])
                    ids.append(i - 1 if i > 0 else len(verts) + i)
                faces.append(ids)
    return np.asarray(verts, np.float64).reshape(-1, 3), np.asarray(faces, np.int64).reshape(-1, 3)


class Scene(NamedTuple):
    """Triangle soup and shading tables on one device."""

    v0: torch.Tensor  # (F,3)
    v1: torch.Tensor
    v2: torch.Tensor
    mat: torch.Tensor  # (F,) material index
    verts: torch.Tensor  # (V,3) the indexed vertices v0/v1/v2 were taken from
    faces: torch.Tensor  # (F,3)
    base_color: torch.Tensor  # (M,3)
    kd: torch.Tensor  # (M,)
    ks: torch.Tensor
    spec_alpha: torch.Tensor
    ka: torch.Tensor
    km: torch.Tensor
    reflective: torch.Tensor  # (M,) bool
    light_pos: torch.Tensor  # (3,)
    light_intensity: torch.Tensor  # ()


def load_verts_faces(config: dict):
    """The configuration's meshes concatenated: (verts (V,3) float32 numpy,
    faces (F,3) int64, material index (F,) int64).  Each mesh's vertices
    are scale * (coord + offset), taken in float64 and rounded once
    (Parallel/raytracer.cu:824)."""
    vs, fs, ms = [], [], []
    base = 0
    for m in config["meshes"]:
        v, f = read_obj(os.path.join(REPO, m["obj"]))
        v = (float(m.get("scale", 1.0)) * (v + np.asarray(m.get("offset", (0, 0, 0)),
                                                            np.float64))).astype(np.float32)
        vs.append(v)
        fs.append(f + base)
        ms.append(np.full((f.shape[0],), int(m["material"]), np.int64))
        base += v.shape[0]
    return np.concatenate(vs), np.concatenate(fs), np.concatenate(ms)


def make_scene(config: dict, device, dtype=torch.float32, verts=None) -> Scene:
    """The scene of a configuration on `device` in `dtype`; `verts` (V,3)
    replaces the meshes' vertices (a perturbed start of a fit)."""
    v_np, f_np, m_np = load_verts_faces(config)
    verts = (torch.as_tensor(v_np, device=device) if verts is None else verts).to(dtype)
    faces = torch.as_tensor(f_np, device=device)
    mats = config["materials"]

    def col(key, dt=dtype):
        return torch.tensor([m[key] for m in mats], dtype=dt, device=device)

    light = config["light"]
    return Scene(
        v0=verts[faces[:, 0]], v1=verts[faces[:, 1]], v2=verts[faces[:, 2]],
        mat=torch.as_tensor(m_np, device=device), verts=verts, faces=faces,
        base_color=col("base_color"), kd=col("kd"), ks=col("ks"),
        spec_alpha=col("spec_alpha"), ka=col("ka"), km=col("km"),
        reflective=col("reflective", torch.bool),
        light_pos=torch.tensor(light["position"], dtype=dtype, device=device),
        light_intensity=torch.tensor(float(light["intensity"]), dtype=dtype, device=device),
    )


def with_verts(scene: Scene, verts: torch.Tensor) -> Scene:
    """The scene with new indexed vertices (the triangle soup follows)."""
    f = scene.faces
    return scene._replace(verts=verts, v0=verts[f[:, 0]], v1=verts[f[:, 1]], v2=verts[f[:, 2]])


# --------------------------------------------------------------------------
# vector helpers, one elementwise op at a time
# --------------------------------------------------------------------------


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(a):
    """a / |a|, zero vectors left zero (Serial/geometry.h:23-30)."""
    n2 = dot(a, a)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2, torch.ones_like(n2))),
                      torch.zeros_like(n2))
    return a * inv[..., None]


def det3(a1, a2, a3, b1, b2, b3, c1, c2, c3):
    """Cofactor expansion along the first row (Serial/raytracer.cpp:203-211)."""
    return a1 * (b2 * c3 - b3 * c2) - a2 * (b1 * c3 - b3 * c1) + a3 * (b1 * c2 - b2 * c1)


def cramer(o, d, a, b, c):
    """(t, beta, gamma) of o + t d = a + beta (b - a) + gamma (c - a) by
    Cramer's rule, in the upstream's column order: e1 = a - b, e2 = a - c,
    s = a - o.  Broadcasts over leading dims."""
    e1, e2, s = a - b, a - c, a - o

    def det(p, q, r):
        return det3(p[..., 0], q[..., 0], r[..., 0], p[..., 1], q[..., 1], r[..., 1],
                    p[..., 2], q[..., 2], r[..., 2])

    A = det(e1, e2, d)
    return det(e1, e2, s) / A, det(s, e2, d) / A, det(e1, s, d) / A


# operations of one `cramer` call and its acceptance test, as written
# above: 9 subtractions for the columns, 4 determinants of 17 (12
# products, 5 sums), 3 divisions, then beta > 0, gamma > 0, beta + gamma
# < 1 and the two t comparisons (one sum, five comparisons)
CRAMER_TEST_OPS = 9 + 4 * 17 + 3 + 6
