"""Kernel E's work in a Whitted wave frame of the parallel scene: each
pixel's primary ray, every mirror bounce to the configuration's depth,
and each hit's shadow ray, walked as the upstream walks them (nearest
hits, first blockers).  Inputs: the scene and the grid (E makes its
camera rays itself); outputs: one color a pixel (12 bytes)."""

from __future__ import annotations

from raybench.reference.camera import camera_rays
from raybench.reference.whitted import render_parallel
from raybench.work.common import input_bytes, ops_of, pixel_passes, scene_and_grid


def count(config: dict, traffic: dict, device) -> dict:
    size = int(traffic["size"])
    scene, grid = scene_and_grid(config, device)
    tested = visits = 0
    for px in pixel_passes(size, device):
        o, d = camera_rays(config["camera"], size, size, px, scene.v0.dtype)
        _, walks = render_parallel(scene, grid, o, d, config["shading"])
        tested += sum(w.tested for w in walks)
        visits += sum(w.steps for w in walks)
    rays = size * size
    return {"tested": tested, "visits": visits, "ops": ops_of(tested, visits),
            "bytes": input_bytes(scene, grid) + rays * 12, "rays": rays}
