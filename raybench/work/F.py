"""Kernel F's work in a path-traced frame: each pixel's camera ray and
its hit's shadow ray once (every sample of a pixel shares them), then
each sample's bounce segments to the traffic's depth and each bounce
hit's shadow ray, walked as `raybench/reference/pathtrace.py` follows
them (the program's sampler, so the very paths).  Inputs: the scene and
the grid (F makes its camera rays itself); outputs: one radiance a pixel
(12 bytes)."""

from __future__ import annotations

from raybench.reference.camera import camera_rays
from raybench.reference.pathtrace import render_gi
from raybench.work.common import input_bytes, ops_of, pixel_passes, scene_and_grid


def count(config: dict, traffic: dict, device) -> dict:
    size = int(traffic["size"])
    r = traffic["render"]
    scene, grid = scene_and_grid(config, device)
    tested = visits = 0
    for px in pixel_passes(size, device):
        o, d = camera_rays(config["camera"], size, size, px, scene.v0.dtype)
        walks = []
        render_gi(scene, grid, o, d, config["shading"], r["gi_samples"], r["gi_depth"], walks)
        for s, k, seg, sh in walks:
            if k > 0 or s == 0:
                tested += seg.tested + sh.tested
                visits += seg.steps + sh.steps
    rays = size * size
    return {"tested": tested, "visits": visits, "ops": ops_of(tested, visits),
            "bytes": input_bytes(scene, grid) + rays * 12, "rays": rays}
