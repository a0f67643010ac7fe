"""Pinhole look-at camera: the whole image's primary rays as one batch.

Counterpart of `ray_tracer_tpu/ops/camera.py` for spp == 1 and the
pinhole (aperture 0), the reference's camera model
(Serial/raytracer.cpp:124-138, 150-161):

    w  = -normalize(target - pos)
    u  = normalize(up x w)
    v  = normalize(w x u)
    fd = 1 / (2 tan(fov/2))
    dir(x, y) = normalize(-w*fd + u * ar*(x - W/2 + 0.5)/W
                                + v *    (y - H/2 + 0.5)/H)

Pixel (x, y) maps to flat index y*W + x.  The subpixel offset 0.5 and
the focal distance are host-side Python floats, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ray_tracer_tpu_torch.config import CameraConfig
from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.device import resolve_device


def camera_basis(cfg: CameraConfig, dtype=torch.float32, device=None):
    dev = resolve_device(device)
    pos = torch.tensor(cfg.position, dtype=dtype, device=dev)
    target = torch.tensor(cfg.target, dtype=dtype, device=dev)
    up = vm.normalize(torch.tensor(cfg.up, dtype=dtype, device=dev))
    w = vm.normalize(-(target - pos))
    u = vm.normalize(vm.cross(up, w))
    v = vm.normalize(vm.cross(w, u))
    focal_distance = 1.0 / (2.0 * math.tan(cfg.fov_degrees * math.pi / 360.0))
    return pos, u, v, w, focal_distance


def camera_rays(cfg: CameraConfig, dtype=torch.float32, spp: int = 1,
                device=None) -> RayBatch:
    """Primary rays for every pixel, flat index = y*W + x."""
    if spp != 1 or cfg.aperture > 0.0:
        raise NotImplementedError(
            "the port's camera serves spp == 1 with the pinhole only"
        )
    pos, u, v, w, fd = camera_basis(cfg, dtype=dtype, device=device)
    width, height = cfg.width, cfg.height
    aspect = float(width) / float(height)
    ox = oy = 0.5  # the pixel-center subpixel offset, (0 + 0.5) / 1
    x = torch.arange(width, dtype=dtype, device=pos.device)
    y = torch.arange(height, dtype=dtype, device=pos.device)
    xw = vm.div_scalar(aspect * (x - width / 2.0 + ox), width)  # (W,)
    yw = vm.div_scalar(y - height / 2.0 + oy, height)  # (H,)
    dirs = (
        -w * fd
        + u * xw[None, :, None]  # broadcast over (H, W, 3)
        + v * yw[:, None, None]
    )
    dirs = vm.normalize(dirs).reshape(-1, 3)
    orig = pos.expand(dirs.shape).contiguous()
    return RayBatch.make(orig, dirs, mint=0.0, maxt=math.inf)
