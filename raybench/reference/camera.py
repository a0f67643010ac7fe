"""The upstream's look-at pinhole camera (Serial/raytracer.cpp:124-138,
150-161), one ray a pixel through its centre:

    w  = -normalize(target - pos),  u = normalize(up x w),  v = normalize(w x u)
    fd = 1 / (2 tan(fov / 2))
    dir(x, y) = normalize(-w fd + u ar (x - W/2 + 1/2) / W + v (y - H/2 + 1/2) / H)

Pixel (x, y) has the flat index y W + x.
"""

from __future__ import annotations

import math

import torch

from raybench.reference.geometry import cross, normalize


def camera_rays(camera: dict, width: int, height: int, pixels: torch.Tensor, dtype):
    """(orig, dir), each (P,3) in `dtype`, of the flat pixel indices
    `pixels` (a 1-D int64 tensor on the rays' device)."""
    dev = pixels.device

    def vec(key):
        return torch.tensor(camera[key], dtype=dtype, device=dev)

    pos = vec("position")
    w = normalize(-(vec("target") - pos))
    u = normalize(cross(normalize(vec("up")), w))
    v = normalize(cross(w, u))
    fd = 1.0 / (2.0 * math.tan(float(camera["fov_degrees"]) * math.pi / 360.0))
    x = (pixels % width).to(dtype)
    y = (pixels // width).to(dtype)
    aspect = float(width) / float(height)
    # true divisions: a 0-d divisor (the card multiplies by the reciprocal
    # of a Python number)
    xw = aspect * (x - width / 2.0 + 0.5) / torch.tensor(float(width), dtype=dtype, device=dev)
    yw = (y - height / 2.0 + 0.5) / torch.tensor(float(height), dtype=dtype, device=dev)
    d = normalize(-w * fd + u * xw[:, None] + v * yw[:, None])
    return pos.expand(d.shape).contiguous(), d
