"""Look-at camera: the whole image's primary rays as one batch, or the
rays of arbitrary queue positions.

Counterpart of `ray_tracer_tpu/ops/camera.py` (`camera_basis`,
`_subpixel_offset`, `_lens_offset`, `_focus_distance`, `_lens_rays`,
`_rays_from_grid`, `camera_rays`, `camera_rays_subsample`,
`camera_ray_at`), the reference's camera model
(Serial/raytracer.cpp:124-138, 150-161):

    w  = -normalize(target - pos)
    u  = normalize(up x w)
    v  = normalize(w x u)
    fd = 1 / (2 tan(fov/2))
    dir(x, y) = normalize(-w*fd + u * ar*(x - W/2 + ox)/W
                                + v *    (y - H/2 + oy)/H)

Pixel (x, y) maps to flat index y*W + x.  spp > 1 takes spp x spp
regular subpixel samples a pixel, subsample-major (ray s*H*W + y*W + x),
and an aperture > 0 with spp > 1 moves each subsample's origin to a
golden-spiral point of the lens disk and re-aims it at the pixel's point
on the focal plane (thin-lens depth of field).  The subpixel offsets,
lens points and focus distance are host-side Python floats, as in the
JAX package, and every divide by a host constant is a true division
(`vecmath.div_scalar`, or a 0-d tensor as the dividend).

`camera_ray_at` makes the rays of given flat indices with the same
arithmetic, bitwise equal to the batch; `camera_launch` holds what a
kernel that makes camera rays itself takes (csrc/camera.cuh): the basis
from `camera_basis` on the CPU and the subsample table of the same
Python floats, made once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def _subpixel_offset(s: int, spp: int) -> "tuple[float, float]":
    """(ox, oy) of subsample s as Python floats, narrowed at use (spp == 1
    gives the pixel center 0.5 exactly)."""
    sx, sy = s % spp, s // spp
    return (sx + 0.5) / spp, (sy + 0.5) / spp


def _lens_offset(cfg: CameraConfig, s: int, spp: int):
    """(lx, ly) lens-disk point of subsample s as Python floats, or None
    for the pinhole: a golden spiral whose radius grows with the square
    root, so the points are area-uniform."""
    n = spp * spp
    if cfg.aperture <= 0.0 or n == 1:
        return None
    r = cfg.aperture * math.sqrt((s + 0.5) / n)
    th = s * math.pi * (3.0 - math.sqrt(5.0))
    return r * math.cos(th), r * math.sin(th)


def _focus_distance(cfg: CameraConfig) -> float:
    if cfg.focus_distance > 0.0:
        return float(cfg.focus_distance)
    return math.dist(cfg.position, cfg.target)


def _lens_rays(pos, u, v, w, dirs, lx, ly, focus: float):
    """Thin-lens transform of normalized pinhole dirs: the origin moves to
    the lens point pos + u*lx + v*ly and the direction re-aims at the
    pixel's point on the focal plane (focus along the view axis -w)."""
    cosw = -vm.dot(dirs, w)  # > 0 for any fov < 180
    # a 0-d dividend: `python_float / tensor` multiplies by the reciprocal
    focal = pos + dirs * (torch.tensor(focus, dtype=dirs.dtype, device=dirs.device)
                          / cosw)[..., None]
    orig = pos + u * lx + v * ly
    ndir = vm.normalize(focal - orig)
    return orig.expand(ndir.shape).contiguous(), ndir


def _rays_from_grid(cfg: CameraConfig, ox: float, oy: float, dtype, lens=None,
                    device=None):
    """(orig, dirs) of shape (H*W, 3) for one subsample offset; `lens` is
    an (lx, ly) lens point or None for the pinhole."""
    pos, u, v, w, fd = camera_basis(cfg, dtype=dtype, device=device)
    width, height = cfg.width, cfg.height
    aspect = float(width) / float(height)
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
    if lens is None:
        return pos.expand(dirs.shape).contiguous(), dirs
    lx, ly = (torch.tensor(c, dtype=dtype, device=pos.device) for c in lens)
    return _lens_rays(pos, u, v, w, dirs, lx, ly, _focus_distance(cfg))


def camera_rays(cfg: CameraConfig, dtype=torch.float32, spp: int = 1,
                device=None) -> RayBatch:
    """Primary rays for every pixel and subsample, flat index
    s*H*W + y*W + x; spp == 1 is the reference's pixel-center batch."""
    parts = [
        _rays_from_grid(cfg, *_subpixel_offset(s, spp), dtype,
                        lens=_lens_offset(cfg, s, spp), device=device)
        for s in range(spp * spp)
    ]
    if len(parts) == 1:
        orig, dirs = parts[0]
    else:
        orig = torch.cat([o for o, _ in parts], dim=0)
        dirs = torch.cat([d for _, d in parts], dim=0)
    return RayBatch.make(orig, dirs, mint=0.0, maxt=math.inf)


def camera_rays_subsample(cfg: CameraConfig, s: int, spp: int, dtype=torch.float32,
                          device=None) -> RayBatch:
    """The (H*W,) batch of subsample s (0 <= s < spp*spp), bitwise equal to
    rays [s*H*W:(s+1)*H*W] of camera_rays(cfg, spp=spp)."""
    orig, dirs = _rays_from_grid(cfg, *_subpixel_offset(s, spp), dtype,
                                 lens=_lens_offset(cfg, s, spp), device=device)
    return RayBatch.make(orig, dirs, mint=0.0, maxt=math.inf)


def subsample_table(cfg: CameraConfig, spp: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """(spp*spp, 4) [ox, oy, lx, ly] of every subsample: the Python floats
    the batch bakes in, narrowed to dtype (lx = ly = 0 for the pinhole)."""
    rows = []
    for s in range(spp * spp):
        lens = _lens_offset(cfg, s, spp)
        rows.append((*_subpixel_offset(s, spp), *(lens if lens is not None else (0.0, 0.0))))
    return torch.tensor(rows, dtype=dtype, device=resolve_device(device))


def camera_ray_at(cfg: CameraConfig, idx: torch.Tensor, dtype=torch.float32, spp: int = 1,
                  device=None) -> RayBatch:
    """Rays of arbitrary flat indices idx = s*H*W + y*W + x (subsample s <
    spp*spp), bitwise equal to those rows of camera_rays: the zero-gather
    ray source of the persistent wave's refill."""
    pos, u, v, w, fd = camera_basis(cfg, dtype=dtype, device=device)
    dev = pos.device
    width, height = cfg.width, cfg.height
    aspect = float(width) / float(height)
    hw = width * height
    idx = idx.to(device=dev, dtype=torch.int64)
    p = idx % hw
    yi = (p // width).to(dtype)
    xi = (p % width).to(dtype)
    s = torch.clamp(idx // hw, 0, spp * spp - 1)
    tab = subsample_table(cfg, spp, dtype, dev)[s]  # per-lane gather of host constants
    xw = vm.div_scalar(aspect * (xi - width / 2.0 + tab[:, 0]), width)
    yw = vm.div_scalar(yi - height / 2.0 + tab[:, 1], height)
    dirs = vm.normalize(-w * fd + u * xw[:, None] + v * yw[:, None])
    if _lens_offset(cfg, 0, spp) is None:
        return RayBatch.make(pos.expand(dirs.shape).contiguous(), dirs, mint=0.0, maxt=math.inf)
    orig, dirs = _lens_rays(pos, u, v, w, dirs, tab[:, 2:3], tab[:, 3:4], _focus_distance(cfg))
    return RayBatch.make(orig, dirs, mint=0.0, maxt=math.inf)


def queue_rays(cfg: CameraConfig, pix_offset: int, pix_stride: int, queue_len: int,
               device=None) -> RayBatch:
    """The rays of a sharded wave queue (the JAX waves' pix_offset /
    pix_stride / queue_len): position k takes the camera_rays row of pixel
    gid = pix_offset + k * pix_stride.  A dead position (gid >= H*W)
    takes the last pixel's ray, as the JAX waves' clipped index does, with
    maxt -inf, so that it never enters the grid."""
    r = cfg.width * cfg.height
    rays = camera_rays(cfg, device=device)
    gid = pix_offset + torch.arange(queue_len, dtype=torch.int64, device=rays.orig.device) \
        * pix_stride
    idx = torch.clamp(gid, 0, r - 1)
    maxt = torch.where(gid < r, rays.maxt[idx], torch.full_like(rays.maxt[idx], -math.inf))
    return RayBatch(rays.orig[idx], rays.dirn[idx], rays.mint[idx], maxt)


class CameraLaunch(NamedTuple):
    """What a kernel that makes camera rays takes (csrc/camera.cuh): the
    camera and spp it was made for, the f32 launch values as Python
    floats (the basis from camera_basis on the CPU, then fd, aspect,
    W/2, H/2, W, H and the focus distance, each narrowed as the batch
    narrows it), whether the thin lens is on, and the subsample table on
    the kernel's device."""

    camera: CameraConfig
    spp: int
    basis: tuple  # pos, u, v, w: 3 floats each
    scalars: tuple  # fd, aspect, W/2, H/2, W, H, focus
    lens: bool
    table: torch.Tensor  # (spp*spp, 4) f32 [ox, oy, lx, ly]


def camera_launch(cfg: CameraConfig, spp: int = 1, device=None) -> CameraLaunch:
    """The camera's launch values for spp; the table is the one copy to
    the device, so callers make this once (`render.renderer.prepare`)."""
    pos, u, v, w, fd = camera_basis(cfg, device="cpu")
    f32 = np.float32
    basis = tuple(tuple(float(x) for x in t.tolist()) for t in (pos, u, v, w))
    width, height = cfg.width, cfg.height
    scalars = tuple(float(f32(x)) for x in (fd, float(width) / float(height), width / 2.0,
                                             height / 2.0, width, height, _focus_distance(cfg)))
    return CameraLaunch(camera=cfg, spp=spp, basis=basis, scalars=scalars,
                        lens=_lens_offset(cfg, 0, spp) is not None,
                        table=subsample_table(cfg, spp, device=device))


def fold_subsamples(colors) -> torch.Tensor:
    """Mean of the per-subsample colors, in subsample order: acc = c0;
    acc = acc + c_s in turn; then the divide by their count (the JAX
    package's accumulate_spp order, on which the spp image is bitwise)."""
    acc, n = None, 0
    for c in colors:
        acc = c if acc is None else acc + c
        n += 1
    return vm.div_scalar(acc, float(n))
