"""Path-traced global illumination, as the program defines its estimator,
in plain torch over the reference's grid walk.

Each pixel's camera ray starts `samples` paths of up to `depth` bounces.
At every hit: the geometric normal normalize((v1 - v0) x (v2 - v0)),
turned against the ray; with a reflective material, a draw u3 < km takes
the mirror (weight km / km) and otherwise the diffuse branch (weight
(1 - km) / (1 - km)); at a diffuse vertex, next-event estimation toward
the point light, albedo / pi * I cos / d^2, unless the vertex's shadow
ray (the Whitted render's, the serial variant pointing it away from the
light) is blocked; then a cosine-weighted direction (Duff et al.'s
orthonormal basis, r = sqrt(u1), phi = 2 pi u2, cos and sin taken in
float64) and the throughput times the albedo, clip(base / 255, 0, 1).
An escaping segment adds the throughput times the background.  The
samples are summed in order and divided by their count.

The random numbers are the program's stated sampler: a lowbias32 hash
of (key + salt), where a path's key is a hash of its camera ray's float32
bits plus 0x632BE59B (sample + 1), and the salts are fixed per depth
and draw.  So the reference draws the very numbers the program draws,
and each pixel's paths are comparable one by one."""

from __future__ import annotations

import math

import torch

from raybench.reference.camera import camera_rays
from raybench.reference.geometry import Scene, cramer, cross, dot, normalize
from raybench.reference.grid import Grid, walk

M32 = 0xFFFFFFFF
SALT = 0x632BE59B


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values held in int64: a in 16-bit halves,
    so no product leaves 48 bits."""
    return ((a & 0xFFFF) * b + (((a >> 16) * b) & 0xFFFF) * 65536) & M32


def hash_u01(x: torch.Tensor, salt: int) -> torch.Tensor:
    """lowbias32(x + salt) -> float32 in [0, 1): the top 24 bits."""
    x = ((x + (salt & M32)) & M32) ^ 0x9E3779B9
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def ray_keys(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A camera ray's key: its six float32 words, each times its own odd
    constant mod 2^32, xor-ed."""
    ob = o.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32
    db = d.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32
    return (mul32(db[:, 0], 0x85EBCA6B) ^ mul32(db[:, 1], 0xC2B2AE35)
            ^ mul32(db[:, 2], 0x27D4EB2F) ^ mul32(ob[:, 0], 0x165667B1)
            ^ mul32(ob[:, 1], 0x9E3779B1) ^ mul32(ob[:, 2], 0xFC0589B5))


def cosine_dir(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(n[:, 2])
    s = torch.where(n[:, 2] >= 0, one, -one)
    a = -one / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    b1 = torch.stack([one + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], dim=-1)
    b2 = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    r = torch.sqrt(u1.to(n.dtype))
    phi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=n.device) * u2
    c = torch.cos(phi.double()).to(n.dtype)
    sn = torch.sin(phi.double()).to(n.dtype)
    z = torch.sqrt(torch.clamp(1.0 - u1.to(n.dtype), min=0.0))
    return (r * c)[:, None] * b1 + (r * sn)[:, None] * b2 + z[:, None] * n


def render_gi(scene: Scene, grid: Grid, o, d, shading: dict, samples: int, depth: int,
              walks: list = None):
    """(R,3) radiance of camera rays (o, d).  `walks`, where given, gets
    (sample, depth, segment walk, shadow walk) of every segment."""
    dt, dev = o.dtype, o.device
    eps = shading["shadow_eps"]
    serial = shading["variant"] == "serial"
    smint = eps if serial else eps + 0.02
    bg = torch.tensor(shading["background"], dtype=dt, device=dev)
    albedo_t = torch.clamp(scene.base_color / torch.tensor(255.0, dtype=dt, device=dev), 0.0, 1.0)
    km_t = torch.clamp(scene.km, 0.0, 1.0) * scene.reflective.to(dt)
    key0 = ray_keys(o, d)
    r = o.shape[0]
    acc = None
    for s in range(samples):
        key = (key0 + mul32(torch.full_like(key0, s + 1), SALT)) & M32
        rad = torch.zeros((r, 3), dtype=dt, device=dev)
        thr = torch.ones((r, 3), dtype=dt, device=dev)
        alive = torch.ones((r,), dtype=torch.bool, device=dev)
        cur_o, cur_d, mint = o, d, 0.0
        for k in range(depth + 1):
            gate = 0.0 if k == 0 and serial else eps
            res = walk(grid, scene.v0, scene.v1, scene.v2, cur_o, cur_d, mint, gate, "nearest")
            hit = res.hit & alive
            rad = rad + torch.where((alive & ~res.hit)[:, None], thr * bg, torch.zeros_like(rad))
            safe = torch.where(res.hit, res.tri, torch.zeros_like(res.tri))
            a, b, c = scene.v0[safe], scene.v1[safe], scene.v2[safe]
            m = scene.mat[safe]
            t, _, _ = cramer(cur_o, cur_d, a, b, c)
            t = torch.where(res.hit, t, torch.zeros_like(t))
            poi = torch.where(res.hit[:, None], cur_o, torch.zeros_like(cur_o)) + cur_d * t[:, None]
            n = normalize(cross(b - a, c - a))
            n = torch.where((dot(n, cur_d) > 0)[:, None], -n, n)
            albedo = albedo_t[m]
            km = km_t[m]
            u3 = hash_u01(key, 0x85EBCA77 * (k + 1) + 13)
            spec = hit & (u3.to(dt) < km)
            one = torch.ones_like(km)
            w = torch.where(spec, km / torch.where(km > 0, km, one),
                            (1.0 - km) / torch.where(km < 1, 1.0 - km, one))
            thr = thr * w[:, None]
            # next-event estimation
            to_l = scene.light_pos - poi
            d2 = dot(to_l, to_l)
            tiny = torch.full_like(d2, 1e-20)
            wl = to_l / torch.sqrt(torch.maximum(d2, tiny))[:, None]
            cos_i = torch.clamp(dot(n, wl), min=0.0)
            sdir = -normalize(scene.light_pos - poi) if serial else normalize(scene.light_pos - poi)
            sorig = torch.where(hit[:, None], poi, torch.full_like(poi, float("inf")))
            sh = walk(grid, scene.v0, scene.v1, scene.v2, sorig, sdir, smint, eps, "any")
            occ = sh.hit
            if walks is not None:
                walks.append((s, k, res, sh))
            lit = hit & ~spec & ~occ
            direct = albedo * (1.0 / math.pi) * (scene.light_intensity * cos_i
                                                   / torch.maximum(d2, tiny))[:, None]
            rad = rad + torch.where(lit[:, None], thr * direct, torch.zeros_like(rad))
            if k == depth:
                break
            u1 = hash_u01(key, 0x1000193 * (k + 1))
            u2 = hash_u01(key, 0x5BD1E995 * (k + 1) + 7)
            nd = cosine_dir(n, u1, u2)
            mdir = cur_d - 2.0 * dot(cur_d, n)[:, None] * n
            nd = torch.where(spec[:, None], mdir, nd)
            thr = thr * torch.where(spec[:, None], torch.ones_like(albedo), albedo)
            alive = hit
            cur_o = torch.where(hit[:, None], poi, torch.full_like(poi, float("inf")))
            cur_d, mint = nd, eps
        acc = rad if acc is None else acc + rad
    return acc / float(samples)


def render_pixels(config: dict, scene: Scene, grid: Grid, width: int, height: int,
                  pixels: torch.Tensor, samples: int, depth: int, dtype=torch.float32):
    o, d = camera_rays(config["camera"], width, height, pixels, dtype)
    return render_gi(scene, grid, o, d, config["shading"], samples, depth)
