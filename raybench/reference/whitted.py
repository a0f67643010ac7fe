"""The upstream's Whitted renders, in plain torch over the reference's
grid walk:

  * serial (Serial/raytracer.cpp:81-117): one nearest hit a pixel
    (t > 0: the port's production hit rule, faithful=False, which kernel
    C requires; the upstream accepts any triangle whose barycentric test
    passes, at any t), the unnormalized normal (v0 - v1) x (v2 - v0), the
    unnormalized half vector, light intensity on diffuse and specular, a
    shadow ray pointed AWAY from the light (the upstream's quirk, mint and
    gate eps) scaling diffuse + specular before the ambient term;
  * parallel (Parallel/raytracer.cu:445-524): a material table, the
    normal (v2 - v1) x (v0 - v1), the normalized half vector, a shadow ray
    toward the light (mint eps + 0.02, gate eps) scaling the whole local
    color, and mirror reflection to `max_bounces`, folded deepest first
    as color_d = local_d + km_d color_{d+1}, where a reflecting hit's
    local color is color * base * (1 - km).

`shade_serial` is differentiable in the scene's vertices, materials and
light; the hits (the walk) never are.
"""

from __future__ import annotations

import torch

from raybench.reference.camera import camera_rays
from raybench.reference.geometry import Scene, cramer, cross, dot, normalize
from raybench.reference.grid import Grid, walk


def _relu(x):
    return torch.maximum(x, torch.zeros_like(x))


def _gather(x, idx):
    return x.index_select(0, idx)


def shade_serial(scene: Scene, o, d, tri, hit, in_shadow, shading: dict, bg):
    """(R,3) colors of serial hits: `tri` (R,) the hit triangle (any value
    where not `hit`), `in_shadow` (R,) bool."""
    safe = torch.where(hit, tri, torch.zeros_like(tri))
    a, b, c = _gather(scene.v0, safe), _gather(scene.v1, safe), _gather(scene.v2, safe)
    m = _gather(scene.mat, safe)
    base = _gather(scene.base_color, m)
    t, _, _ = cramer(o, d, a, b, c)
    t = torch.where(hit, t, torch.zeros_like(t))
    poi = torch.where(hit[:, None], o, torch.zeros_like(o)) + d * t[:, None]
    n = cross(a - b, c - a)
    view = normalize(-d)
    l = normalize(scene.light_pos - poi)
    h = view + l
    ndl, ndh = _relu(dot(n, l)), _relu(dot(n, h))
    I = scene.light_intensity
    diffuse = base * (_gather(scene.kd, m) * ndl)[:, None] * I
    specular = base * (_gather(scene.ks, m) * torch.pow(ndh, _gather(scene.spec_alpha, m)))[:, None] * I
    color = specular + diffuse
    color = torch.where(in_shadow[:, None], color * shading["shadow_scale"], color)
    color = color + base * _gather(scene.ka, m)[:, None]
    return torch.where(hit[:, None], color, bg)


def _poi(o, d, t, hit):
    return torch.where(hit[:, None], o + d * torch.where(hit, t, torch.zeros_like(t))[:, None],
                       torch.full_like(o, float("inf")))


def serial_shadow(scene: Scene, grid: Grid, poi, hit, shading: dict, light_pos=None):
    """The serial shadow rays' any-hit answer: from each hit point, away
    from the light."""
    lp = scene.light_pos if light_pos is None else light_pos
    sdir = -normalize(lp - torch.where(hit[:, None], poi, torch.zeros_like(poi)))
    eps = shading["shadow_eps"]
    return walk(grid, scene.v0, scene.v1, scene.v2, poi, sdir, eps, eps, "any")


def render_serial(scene: Scene, grid: Grid, o, d, shading: dict):
    """(colors (R,3), primary walk, shadow walk) of serial camera rays."""
    bg = torch.tensor(shading["background"], dtype=o.dtype, device=o.device)
    prim = walk(grid, scene.v0, scene.v1, scene.v2, o, d, 0.0, 0.0, "nearest")
    sh = serial_shadow(scene, grid, _poi(o, d, prim.t, prim.hit), prim.hit, shading)
    return shade_serial(scene, o, d, prim.tri, prim.hit, sh.hit & prim.hit, shading, bg), prim, sh


def render_parallel(scene: Scene, grid: Grid, o, d, shading: dict):
    """(colors (R,3), [walks]) of parallel camera rays with mirror bounces."""
    eps = shading["shadow_eps"]
    scale = shading["shadow_scale"]
    bg = torch.tensor(shading["background"], dtype=o.dtype, device=o.device)
    walks = []
    locals_ = []
    cur_o, cur_d, mint = o, d, 0.0
    for depth in range(int(shading["max_bounces"]) + 1):
        res = walk(grid, scene.v0, scene.v1, scene.v2, cur_o, cur_d, mint, eps, "nearest")
        hit = res.hit
        safe = torch.where(hit, res.tri, torch.zeros_like(res.tri))
        a, b, c = _gather(scene.v0, safe), _gather(scene.v1, safe), _gather(scene.v2, safe)
        m = _gather(scene.mat, safe)
        base = _gather(scene.base_color, m)
        t = torch.where(hit, res.t, torch.zeros_like(res.t))
        poi = torch.where(hit[:, None], cur_o, torch.zeros_like(cur_o)) + cur_d * t[:, None]
        n = cross(c - b, a - b)
        view = normalize(-cur_d)
        l = normalize(scene.light_pos - poi)
        h = normalize(view + l)
        ndl, ndh = _relu(dot(n, l)), _relu(dot(n, h))
        color = (base * ndl[:, None] * _gather(scene.kd, m)[:, None]
                 + base * torch.pow(ndh, _gather(scene.spec_alpha, m))[:, None]
                 * _gather(scene.ks, m)[:, None])
        color = color + base * _gather(scene.ka, m)[:, None]
        sorig = torch.where(hit[:, None], poi, torch.full_like(poi, float("inf")))
        sh = walk(grid, scene.v0, scene.v1, scene.v2, sorig, l, eps + 0.02, eps, "any")
        walks += [res, sh]
        color = torch.where((sh.hit & hit)[:, None], color * scale, color)
        km = _gather(scene.km, m)
        reflecting = hit & _gather(scene.reflective, m) & (depth < int(shading["max_bounces"]))
        local = torch.where(reflecting[:, None], color * base * (1.0 - km)[:, None],
                            torch.where(hit[:, None], color, bg))
        locals_.append((local, torch.where(reflecting, km, torch.zeros_like(km))[:, None]))
        if depth == int(shading["max_bounces"]) or not bool(reflecting.any()):
            break
        nd, nn = normalize(cur_d), normalize(n)
        rdir = normalize(nd - nn * (2.0 * dot(nd, nn))[:, None])
        cur_o = torch.where(reflecting[:, None], poi, torch.full_like(poi, float("inf")))
        cur_d, mint = rdir, eps
    result = locals_[-1][0]
    for local, km in reversed(locals_[:-1]):
        result = local + km * result
    return result, walks


def render_pixels(config: dict, scene: Scene, grid: Grid, width: int, height: int,
                  pixels: torch.Tensor, dtype=torch.float32):
    """The colors (P,3) of flat pixel indices `pixels` in the
    configuration's shading variant, in `dtype`."""
    o, d = camera_rays(config["camera"], width, height, pixels, dtype)
    shading = config["shading"]
    if shading["variant"] == "serial":
        return render_serial(scene, grid, o, d, shading)[0]
    return render_parallel(scene, grid, o, d, shading)[0]
