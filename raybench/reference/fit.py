"""The reference of the fit: inverse rendering of the serial scene against
a target image, with Adam, the grid held fixed between rebuilds.

A step renders the whole camera batch with the current parameters, takes
the loss sum(((color - target) / 255)^2) / (3 H W), its gradients in every
trained field, and Adam's update (lr, betas 0.9 and 0.999, eps 1e-8, the
bias-corrected moments).  As the fit holds the grid between rebuilds,
every trace (the primary and the shadow rays) walks the geometry of the
start, the rebuild's, while the shading, t among it, follows the current
vertices; the shadow rays leave the hit point on the start's geometry
toward the current light.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from raybench.reference.camera import camera_rays
from raybench.reference.geometry import Scene, with_verts
from raybench.reference.grid import build_grid, walk
from raybench.reference.whitted import _poi, render_serial, serial_shadow, shade_serial

BETAS = (0.9, 0.999)
EPS = 1e-8


def _scene_with(scene: Scene, p: Dict[str, torch.Tensor]) -> Scene:
    out = scene._replace(**{k: v for k, v in p.items() if k != "verts"})
    return with_verts(out, p["verts"]) if "verts" in p else out


def reference_fit(true_scene: Scene, start: Scene, config: dict, size: int, fields,
                  lr: float, steps: int = 3, half_batch: bool = False):
    """Run `steps` steps of the fit from `start` against the reference's
    own render of `true_scene`.  Returns (losses [steps], the first step's
    gradients by field, the parameters after the last step by field).
    half_batch plants a fault: the loss is the mean over the first half of
    the pixels only."""
    shading = config["shading"]
    dt = start.verts.dtype
    dev = start.verts.device
    pixels = torch.arange(size * size, device=dev)
    o, d = camera_rays(config["camera"], size, size, pixels, dt)
    with torch.no_grad():
        grid_true = build_grid(true_scene.v0, true_scene.v1, true_scene.v2, device=dev)
        target = render_serial(true_scene, grid_true, o, d, shading)[0]
        del grid_true
        grid = build_grid(start.v0, start.v1, start.v2, device=dev)
        prim = walk(grid, start.v0, start.v1, start.v2, o, d, 0.0, 0.0, "nearest")
        poi0 = _poi(o, d, prim.t, prim.hit)
    bg = torch.tensor(shading["background"], dtype=dt, device=dev)
    params = {f: getattr(start, f).detach().clone().requires_grad_(True) for f in fields}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[float] = []
    first = None
    n = size * size
    for k in range(1, steps + 1):
        with torch.no_grad():
            light = params["light_pos"].detach() if "light_pos" in params else start.light_pos
            sh = serial_shadow(start, grid, poi0, prim.hit, shading, light_pos=light)
        cur = _scene_with(start, params)
        colors = shade_serial(cur, o, d, prim.tri, prim.hit, sh.hit & prim.hit, shading, bg)
        r = (colors - target) / torch.tensor(255.0, dtype=dt, device=dev)
        if half_batch:
            r = r[: n // 2]
        loss = torch.sum(r * r) / float(3 * r.shape[0])
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        g = dict(zip(params, grads))
        if first is None:
            first = {f: x.detach().clone() for f, x in g.items()}
        with torch.no_grad():
            for f, p in params.items():
                m[f] = BETAS[0] * m[f] + (1 - BETAS[0]) * g[f]
                v2[f] = BETAS[1] * v2[f] + (1 - BETAS[1]) * g[f] * g[f]
                mhat = m[f] / (1 - BETAS[0] ** k)
                vhat = v2[f] / (1 - BETAS[1] ** k)
                p -= lr * mhat / (torch.sqrt(vhat) + EPS)
    return losses, first, {f: p.detach() for f, p in params.items()}
