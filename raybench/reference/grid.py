"""The upstream's uniform grid (Serial/grid.h:94-101) and its 3D-DDA walk,
vectorised over rays in plain torch.

The grid: the scene's box cut into n_k = clamp(int(delta_k * rm *
cbrt(N) / delta_max + 1), 1, max_res) cells an axis (rm 3 and max_res 64
in the upstream); a triangle lies in every cell its bounding box touches,
in ascending triangle order within a cell.

The walk (`walk`): from the ray's entry into the box, cell by cell in the
order the ray crosses them (the upstream's next-crossing rule), testing
every triangle of each cell with Cramer's rule.  The upstream walks to
the box's far side; what a ray's answer needs is less, and that is what
is walked here and counted:

  * nearest ("nearest"): stop after the first cell whose far side lies
    at or beyond the nearest accepted hit found so far, since no later
    cell can hold a nearer one;
  * any hit ("any", shadow rays): stop after the first cell that holds an
    accepted hit.

A hit is accepted where beta > 0, gamma > 0, beta + gamma < 1 and
t > gate.  Ties in t go to the lowest triangle index.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raybench.reference.geometry import cramer

_NONE = 1 << 62  # no candidate triangle


class Grid(NamedTuple):
    lo: torch.Tensor  # (3,) box corner
    hi: torch.Tensor
    n: tuple  # cells an axis (nx, ny, nz)
    width: torch.Tensor  # (3,)
    inv_width: torch.Tensor
    cell_start: torch.Tensor  # (C+1,) int64
    tri_ids: torch.Tensor  # (E,) int64

    @property
    def entries(self) -> int:
        return int(self.tri_ids.shape[0])

    @property
    def cells(self) -> int:
        return int(self.n[0] * self.n[1] * self.n[2])


def _voxel(p, lo, inv, n):
    """Cell coordinate of p on each axis, clamped (grid.h's PosToVoxel:
    the product truncated toward zero)."""
    return np.clip(((p - lo) * inv).astype(np.int64), 0, np.asarray(n) - 1)


def build_grid(v0, v1, v2, rm: float = 3.0, max_res: int = 64, device=None) -> Grid:
    """The grid of a triangle soup (float32 (F,3) arrays or tensors),
    built in numpy float32 and put on `device`."""
    a, b, c = (np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x, np.float32)
               for x in (v0, v1, v2))
    pts = np.concatenate([a, b, c])
    lo, hi = pts.min(0), pts.max(0)
    delta = hi - lo
    axis = (0 if delta[0] > delta[2] else 2) if delta[0] > delta[1] else \
        (1 if delta[1] > delta[2] else 2)
    vpud = np.float32(rm) * np.float32(np.power(np.float32(a.shape[0]), np.float32(1.0 / 3.0))) \
        / delta[axis]
    n = tuple(int(np.clip(int(delta[k] * vpud + np.float32(1)), 1, max_res)) for k in range(3))
    width = (delta / np.asarray(n, np.float32)).astype(np.float32)
    inv = np.where(width == 0, np.float32(0), np.float32(1) / np.where(width == 0, 1, width))
    inv = inv.astype(np.float32)
    tlo = np.minimum(np.minimum(a, b), c)
    thi = np.maximum(np.maximum(a, b), c)
    vmin, vmax = _voxel(tlo, lo, inv, n), _voxel(thi, lo, inv, n)
    span = vmax - vmin + 1
    per = span.prod(1)
    tri = np.repeat(np.arange(a.shape[0]), per)
    k = np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)
    sx, sy = span[tri, 0], span[tri, 1]
    x = vmin[tri, 0] + k % sx
    y = vmin[tri, 1] + (k // sx) % sy
    z = vmin[tri, 2] + k // (sx * sy)
    cell = (z * n[1] + y) * n[0] + x
    order = np.lexsort((tri, cell))
    counts = np.bincount(cell, minlength=n[0] * n[1] * n[2])
    start = np.concatenate([[0], np.cumsum(counts)])

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dt)

    return Grid(lo=t(lo), hi=t(hi), n=n, width=t(width), inv_width=t(inv),
                cell_start=t(start, torch.int64), tri_ids=t(tri[order], torch.int64))


class WalkResult(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) inf where no hit
    tri: torch.Tensor  # (R,) int64, -1 where no hit
    tested: int  # Cramer tests made over all rays
    steps: int  # cells visited over all rays


def walk(grid: Grid, v0, v1, v2, o, d, mint, gate: float, mode: str = "nearest",
         chunk: int = 1 << 20) -> WalkResult:
    """Walk rays (o, d) (R,3) from `mint` (a float or (R,) tensor) through
    the grid; rays with a non-finite origin are not traced.  The geometry
    and the rays share one dtype; the walk's own bookkeeping follows it."""
    r = o.shape[0]
    dt = o.dtype
    hit = torch.zeros((r,), dtype=torch.bool, device=o.device)
    tt = torch.full((r,), float("inf"), dtype=dt, device=o.device)
    tri = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    mint = torch.as_tensor(mint, dtype=dt, device=o.device).expand(r)
    tested = steps = 0
    for s in range(0, r, chunk):
        sl = slice(s, min(r, s + chunk))
        res = _walk_chunk(grid, v0, v1, v2, o[sl], d[sl], mint[sl], gate, mode)
        hit[sl], tt[sl], tri[sl] = res.hit, res.t, res.tri
        tested += res.tested
        steps += res.steps
    return WalkResult(hit, tt, tri, tested, steps)


def _walk_chunk(grid, v0, v1, v2, o, d, mint, gate, mode):
    r = o.shape[0]
    dev, dt = o.device, o.dtype
    lo, hi = grid.lo.to(dt), grid.hi.to(dt)
    width, inv_w = grid.width.to(dt), grid.inv_width.to(dt)
    n = torch.tensor(grid.n, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    best_t = torch.full((r,), float("inf"), dtype=dt, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)

    # entry: the ray's point at mint if inside the box, else the slab test
    at_min = o + d * mint[:, None]
    inside = ((at_min >= lo) & (at_min <= hi)).all(1)
    inv_d = 1.0 / d
    tn = (lo - o) * inv_d
    tf = (hi - o) * inv_d
    t_near = torch.minimum(tn, tf).nan_to_num(nan=-float("inf"))
    t_far = torch.maximum(tn, tf).nan_to_num(nan=float("inf"))
    t0 = torch.maximum(t_near.amax(1), mint)
    t1 = t_far.amin(1)
    ray_t = torch.where(inside, mint, t0)
    live = torch.isfinite(o).all(1) & (inside | (t0 <= t1))

    p = o + d * ray_t[:, None]
    pos = ((p - lo) * inv_w).nan_to_num(0.0).to(torch.int64)
    pos = torch.minimum(torch.maximum(pos, torch.zeros_like(pos)), n - 1)
    fwd = d >= 0
    edge = lo + (pos + fwd.to(torch.int64)).to(dt) * width
    next_cross = ray_t[:, None] + (edge - p) / d
    delta = torch.where(fwd, width / d, -width / d)
    step = torch.where(fwd, 1, -1)
    out = torch.where(fwd, n, -1)
    next_cross = torch.where(live[:, None], next_cross, inf)

    ids = live.nonzero().squeeze(1)
    tested = visits = 0
    limit = int(sum(grid.n)) + 3
    for _ in range(limit):
        if ids.numel() == 0:
            break
        pc = pos[ids]
        cell = (pc[:, 2] * grid.n[1] + pc[:, 1]) * grid.n[0] + pc[:, 0]
        first = grid.cell_start[cell]
        count = grid.cell_start[cell + 1] - first
        visits += int(ids.numel())
        total = int(count.sum())
        tested += total
        if total:
            lane = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), count)
            k = torch.arange(total, device=dev) - torch.repeat_interleave(
                torch.cumsum(count, 0) - count, count)
            tri = grid.tri_ids[first[lane] + k]
            ray = ids[lane]
            t, beta, gamma = cramer(o[ray], d[ray], v0[tri], v1[tri], v2[tri])
            ok = (beta > 0) & (gamma > 0) & (beta + gamma < 1) & (t > gate)
            if bool(ok.any()):
                ray, t, tri = ray[ok], t[ok], tri[ok]
                before = best_t.clone()
                best_t.scatter_reduce_(0, ray, t, "amin")
                win = t == best_t[ray]
                cand = torch.full((r,), _NONE, dtype=torch.int64, device=dev)
                cand.scatter_reduce_(0, ray[win], tri[win], "amin")
                took = cand < _NONE
                nearer = took & (best_t < before)
                # a nearer t takes its triangle; an equal t keeps the lower index
                best_tri = torch.where(nearer, cand, torch.where(
                    took, torch.minimum(best_tri, cand), best_tri))
        nc = next_cross[ids]
        exit_t = nc.amin(1)
        bt = best_t[ids]
        done = (bt <= exit_t) if mode == "nearest" else torch.isfinite(bt)
        # the upstream's crossing rule: the axis of the smallest next crossing
        x_lt_y = nc[:, 0] < nc[:, 1]
        x_lt_z = nc[:, 0] < nc[:, 2]
        y_lt_z = nc[:, 1] < nc[:, 2]
        axis = torch.where(x_lt_y, torch.where(x_lt_z, 0, 2), torch.where(y_lt_z, 1, 2))
        rows = torch.arange(ids.numel(), device=dev)
        pc = pc.clone()
        pc[rows, axis] += step[ids, axis]
        leaves = pc[rows, axis] == out[ids, axis]
        ncn = nc.clone()
        ncn[rows, axis] += delta[ids, axis]
        pos[ids] = pc
        next_cross[ids] = ncn
        ids = ids[~(done | leaves)]
    hit = torch.isfinite(best_t)
    return WalkResult(hit, best_t, torch.where(hit, best_tri, -1), tested, visits)

