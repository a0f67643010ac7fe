"""Kernel C's work in a Whitted frame of the serial scene (or a fit
step's forward): each pixel's primary ray walked to its nearest hit, and
each hit's shadow ray walked to its first blocker.  Inputs: the camera
rays (24 bytes each), the scene and the grid; outputs: each ray's hit
record (t and triangle, 8 bytes) and its shadow flag (1 byte)."""

from __future__ import annotations

from raybench.reference.camera import camera_rays
from raybench.reference.whitted import render_serial
from raybench.work.common import input_bytes, ops_of, pixel_passes, scene_and_grid


def count(config: dict, traffic: dict, device) -> dict:
    size = int(traffic["size"])
    scene, grid = scene_and_grid(config, device)
    tested = visits = 0
    for px in pixel_passes(size, device):
        o, d = camera_rays(config["camera"], size, size, px, scene.v0.dtype)
        _, prim, sh = render_serial(scene, grid, o, d, config["shading"])
        tested += prim.tested + sh.tested
        visits += prim.steps + sh.steps
    rays = size * size
    return {"tested": tested, "visits": visits, "ops": ops_of(tested, visits),
            "bytes": input_bytes(scene, grid) + rays * (24 + 8 + 1), "rays": rays}
