"""The packed-grid march: kernel C and its plain version.

Counterpart of `ray_tracer_tpu/ops/traverse_packed.py` (`_slab_entry`,
`chord_keys`, `_march_step`, `_chain_probe`, `_primary_exhausted`,
`_fused_retire_rearm`, `traverse_packed`, `traverse_packed_fused_shadow`),
the stateless DDA over the block-packed grid of `accel/packed.py`:

  * a lane not mid-voxel probes the point t_cur + max(delta, t_cur*4e-6),
    decodes the cell's header (inline row or cell_info word) and either
    leaps the cell's empty box or starts testing its rows, the first row
    in the same step;
  * a lane mid-voxel tests one row of `block_tris` triangles a step and
    keeps the nearest accepted (row, slot): lowest slot on ties in a row,
    strict `<` across rows;
  * a primary lane retires once it walks past min(maxt, best_t) between
    cells, or off the grid; in the fused march it then rearms in place as
    its own shadow ray, which retires at its first row with an accepted
    hit.  The triangle id is resolved through `slot_tri` at the end.

The plain version (`march_plain`) is the JAX package's lock-step loop in
plain PyTorch, one elementwise op at a time, dead lanes frozen by masks;
held bitwise against the JAX functions run op by op
(tests/test_torch_packed_march.py).  Two conversions are written out
because PyTorch and CUDA differ from XLA there:

  * `nan_to_num`: `_slab_entry` remaps NaN to -inf/+inf and keeps the
    infinities; the box-exit `tf` gives only nan=inf, so JAX's sequential
    remap turns NaN into +inf and then every +inf into FLT_MAX, and -inf
    into -FLT_MAX (torch.nan_to_num would leave NaN as +inf);
  * the probe's float-to-int cell cast saturates and maps NaN to 0 in
    XLA; `_probe_cell` writes that out (clamped to [-1, n], which keeps
    every inside/outside decision and every in-grid cell).

`march_cuda` launches `csrc/packed_march.cu` (kernel C): each lane
marches one ray and the warp deals out the slots of the rows its lanes
test in a step (tests/test_torch_kernel_layouts.py models that fold in
numpy), one lane per queue position, with the plain version's records
bit for bit.  `march` takes the
kernel for CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ray_tracer_tpu_torch.accel.packed import (
    PackedGridArrays,
    PackedGridMeta,
    decode_cell_info,
    decode_inline_header,
)
from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.kernels import _build
from ray_tracer_tpu_torch.ops.intersect import cramer_tbg

_INF = float("inf")
_FLT_MAX = float(np.finfo(np.float32).max)


class PackedTraceResult(NamedTuple):
    any_pass: torch.Tensor  # == hit (the production path has no any_pass)
    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) f32
    tri_id: torch.Tensor  # (R,) i32, -1 on miss
    steps: torch.Tensor  # (R,) i32


class FusedTraceResult(NamedTuple):
    hit: torch.Tensor  # (R,) bool, primary hit
    t: torch.Tensor  # (R,) f32 primary nearest t
    tri_id: torch.Tensor  # (R,) i32 primary triangle (-1 on miss)
    in_shadow: torch.Tensor  # (R,) bool, the shadow ray found a blocker
    shadow_tri_id: torch.Tensor  # (R,) i32 blocker id (-1 if unshadowed)
    steps: torch.Tensor  # (R,) i32 march steps, both phases


def _default_max_steps(meta: PackedGridMeta) -> int:
    """Every cell of the longest axis walk occupied at max_blocks rows:
    one probe step plus max_blocks row steps per cell."""
    nx, ny, nz = meta.n_voxels
    return (nx + ny + nz + 2) * (meta.max_blocks + 1) + 64


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _slab_interval(grid, o, d, mint, maxt):
    """The grid AABB's (t0, t1) per lane.  NaN from an origin on a slab
    plane with a parallel direction (0*inf) means the ray runs inside that
    slab: its interval is (-inf, +inf); infinities are kept."""
    invd = torch.reciprocal(d)
    t_near = (grid.lower - o) * invd
    t_far = (grid.upper - o) * invd
    lo = torch.nan_to_num(torch.minimum(t_near, t_far), nan=-_INF, posinf=_INF,
                          neginf=-_INF)
    hi = torch.nan_to_num(torch.maximum(t_near, t_far), nan=_INF, posinf=_INF,
                          neginf=-_INF)
    return torch.maximum(lo.amax(dim=-1), mint), torch.minimum(hi.amin(dim=-1), maxt)


def _slab_entry(grid, o, d, mint, maxt):
    """Grid entry t and entered flag (per-lane o/d).  Rays with a NaN/inf
    component or a zero direction never enter."""
    t0, t1 = _slab_interval(grid, o, d, mint, maxt)
    well_formed = (torch.all(torch.isfinite(o) & torch.isfinite(d), dim=-1)
                   & torch.any(d != 0.0, dim=-1))
    return t0, (t0 <= t1) & torch.isfinite(t0) & well_formed


def chord_keys(rays: RayBatch, grid) -> torch.Tensor:
    """Work-queue keys: the negated grid-slab chord length (t1 - t0), +inf
    for rays that never enter; ascending order serves long chords first
    (RenderConfig.queue_order="chord")."""
    t0, t1 = _slab_interval(grid, *(x.to(torch.float32) for x in rays))
    chord = torch.clamp(t1 - t0, min=0.0)
    ok = (t0 <= t1) & torch.isfinite(t0) & torch.isfinite(chord)
    return torch.where(ok, -chord, torch.full_like(chord, _INF))


def _probe_cell(pf: torch.Tensor, nvox_f: torch.Tensor) -> torch.Tensor:
    """floor(pf) -> int32 cell as XLA's cast gives it for the decisions the
    march makes: NaN -> 0, then clamped to [-1, n] (out-of-grid stays out,
    in-grid values are exact)."""
    f = torch.floor(pf)
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return torch.minimum(torch.clamp(f, min=-1.0), nvox_f).to(torch.int32)


def _nan_to_num_inf(x: torch.Tensor) -> torch.Tensor:
    """jnp.nan_to_num(x, nan=inf): its remaps run in turn, so NaN becomes
    +inf and then, with every +inf, FLT_MAX; -inf becomes -FLT_MAX."""
    big = torch.full_like(x, _FLT_MAX)
    return torch.where(torch.isnan(x) | (x == _INF), big, torch.where(x == -_INF, -big, x))


def _box_exit(grid, cell, lo_e, hi_e, o, invd, probe):
    """Exit t of the safe box (the cell, or its empty box); never below the
    probe point."""
    blo = grid.lower + (cell - lo_e).to(torch.float32) * grid.width
    bhi = grid.lower + (cell + hi_e + 1).to(torch.float32) * grid.width
    tf = _nan_to_num_inf(torch.maximum((blo - o) * invd, (bhi - o) * invd))
    return torch.maximum(tf.amin(dim=-1), probe)


def _probe(s, o, d, grid, meta):
    """The cell probe of lanes not mid-voxel: (probe t, cell (R,3) i32,
    inside, linear index clipped into the grid)."""
    dev = o.device
    nx, ny, nz = meta.n_voxels
    nvox = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    t_cur = s["t_cur"]
    probe = t_cur + torch.maximum(_f32(meta.probe_delta, dev), t_cur * _f32(4e-6, dev))
    p = o + d * probe[:, None]
    cell = _probe_cell((p - grid.lower) * grid.inv_width, nvox.to(torch.float32))
    inside = torch.all((cell >= 0) & (cell < nvox), dim=-1)
    cc = torch.minimum(torch.clamp(cell, min=0), nvox - 1)
    lin = cc[:, 2] * (nx * ny) + cc[:, 1] * nx + cc[:, 0]
    return probe, cell, inside, lin


def _march_step(s, *, o, d, invd, gate, maxt, grid, meta, need_hit_tri=False,
                probe_chain=1, stats=None):
    """One cell-probe phase + one block-row test phase for every lane
    (ray_tracer_tpu/ops/traverse_packed.py:152-310).  Updates the march
    keys of dict `s`; other keys pass through."""
    dev = o.device
    r = o.shape[0]
    n_blocks = meta.n_blocks
    bt = meta.block_tris
    alive, testing, t_cur = s["alive"], s["testing"], s["t_cur"]

    probe, cell, inside, lin = _probe(s, o, d, grid, meta)
    fetch = alive & ~testing
    die = fetch & ~inside

    if meta.inline:
        # the one row read of the step: the probed cell's row (header +
        # first triangles) for probing lanes, the next overflow row for
        # lanes mid-cell
        gidx = torch.where(
            testing,
            torch.clamp(s["first_blk"] + s["cursor"] - 1, 0, n_blocks - 1),
            torch.clamp(lin, 0, n_blocks - 1),
        )
        row = grid.blocks[gidx.long()]
        first, nblk, ext_lo, ext_hi = decode_inline_header(row)
    else:
        first, nblk, ext_lo, ext_hi = decode_cell_info(grid.cell_info[lin.long()])
    occupied = nblk > 0

    zero3 = torch.zeros_like(ext_lo)
    lo_e = torch.where(occupied[:, None], zero3, ext_lo)
    hi_e = torch.where(occupied[:, None], zero3, ext_hi)
    t_exit = _box_exit(grid, cell, lo_e, hi_e, o, invd, probe)

    start_test = fetch & inside & occupied
    jump = fetch & inside & ~occupied
    first_blk = torch.where(start_test, first, s["first_blk"])
    n_blk = torch.where(start_test, nblk, s["n_blk"])
    cursor = torch.where(start_test, torch.zeros_like(s["cursor"]), s["cursor"])
    t_exit_cell = torch.where(start_test, t_exit, s["t_exit_cell"])
    t_cur = torch.where(jump, t_exit, t_cur)
    testing = testing | start_test
    alive = alive & ~die

    # one block row; a lane that just probed into an occupied cell tests
    # that cell's first row in this same step
    if meta.inline:
        blk = gidx
    else:
        blk = torch.clamp(first_blk + cursor, 0, n_blocks - 1)
        row = grid.blocks[blk.long()]
    tri = row[:, : bt * 9].reshape(r, bt, 9)
    t, beta, gamma = cramer_tbg(o[:, None, :], d[:, None, :],
                                tri[..., 0:3], tri[..., 3:6], tri[..., 6:9],
                                det_dtype=torch.float32)
    accept = ((beta > 0) & (gamma > 0) & (beta + gamma < 1)
              & (t > gate[:, None]) & (t <= maxt[:, None]) & testing[:, None])
    tm = torch.where(accept, t, torch.full_like(t, _INF))
    slot = torch.argmin(tm, dim=-1).to(torch.int32)  # lowest slot on ties
    m = tm.amin(dim=-1)
    upd = m < s["best_t"]

    if stats is not None:
        stats["tested"] += testing.to(torch.int32)
        if stats.get("passes") is not None:  # slots tested that pass barycentric
            passed = (beta > 0) & (gamma > 0) & (beta + gamma < 1) & testing[:, None]
            stats["passes"] += passed.sum()
        if stats["touched"] is not None:
            if meta.inline:
                stats["touched"][gidx[fetch & inside].long()] |= 1
            stats["touched"][blk[testing].long()] |= 2

    cursor = torch.where(testing, cursor + 1, cursor)
    done = testing & (cursor >= n_blk)
    extra = {}
    if need_hit_tri:
        # the winning triangle's nine floats, from the row in hand
        win = tri[torch.arange(r, device=dev), slot.long()]
        extra["best_tri9"] = torch.where(upd[:, None], win, s["best_tri9"])
    out = dict(
        s,
        alive=alive,
        testing=testing & ~done,
        t_cur=torch.where(done, t_exit_cell, t_cur),
        t_exit_cell=t_exit_cell,
        first_blk=first_blk,
        n_blk=n_blk,
        cursor=cursor,
        best_t=torch.where(upd, m, s["best_t"]),
        best_blk=torch.where(upd, blk, s["best_blk"]),
        best_slot=torch.where(upd, slot, s["best_slot"]),
        **extra,
    )
    if probe_chain > 1:
        if meta.inline:
            raise ValueError("probe_chain > 1 serves the blocks layout only")
        for _ in range(probe_chain - 1):
            out = _chain_probe(out, o=o, d=d, invd=invd, grid=grid, meta=meta)
    return out


def _chain_probe(s, *, o, d, invd, grid, meta):
    """One more cell probe for lanes that are pure leapers after the main
    phase (blocks layout): leap again, or arm an occupied cell for the
    next step's row test (traverse_packed.py:313-354)."""
    alive, testing, t_cur = s["alive"], s["testing"], s["t_cur"]
    act = alive & ~testing
    probe, cell, inside, lin = _probe(s, o, d, grid, meta)
    die = act & ~inside
    first, nblk, ext_lo, ext_hi = decode_cell_info(grid.cell_info[lin.long()])
    occupied = nblk > 0
    zero3 = torch.zeros_like(ext_lo)
    lo_e = torch.where(occupied[:, None], zero3, ext_lo)
    hi_e = torch.where(occupied[:, None], zero3, ext_hi)
    t_exit = _box_exit(grid, cell, lo_e, hi_e, o, invd, probe)
    start = act & inside & occupied
    jump = act & inside & ~occupied
    return dict(
        s,
        alive=alive & ~die,
        testing=testing | start,
        t_cur=torch.where(jump, t_exit, t_cur),
        t_exit_cell=torch.where(start, t_exit, s["t_exit_cell"]),
        first_blk=torch.where(start, first, s["first_blk"]),
        n_blk=torch.where(start, nblk, s["n_blk"]),
        cursor=torch.where(start, torch.zeros_like(s["cursor"]), s["cursor"]),
    )


def _primary_exhausted(s, limit, walked_out):
    """A primary lane is done when it walks past min(maxt, best_t) between
    cells (a lane mid-row finishes the cell first) or walks off the grid."""
    return (s["alive"] & ~s["testing"] & (s["t_cur"] > limit)) | walked_out


def _fused_retire_rearm(s, *, pre_alive, maxt_primary, light, serial_quirk,
                        shadow_gate, shadow_mint, grid, skip_dead_shadow=False,
                        shade_serial=False):
    """Retire lanes and rearm a finished primary in place as its shadow
    ray (traverse_packed.py:366-489).  Returns (s, aux) with aux["done"]
    and aux["in_shadow"] for lanes that finished this step.

    skip_dead_shadow: a hit with n.l <= -m and n.h <= -m under the facet
    normal (m = 2e-5 |e1| |e2|) gets exactly zero direct light, so it
    retires unshadowed without marching its shadow ray (needs carry key
    "best_tri9")."""
    dev = s["best_t"].device
    inf = _f32(_INF, dev)
    phase = s["phase"]
    best_t, testing, t_cur = s["best_t"], s["testing"], s["t_cur"]
    walked_out = pre_alive & ~s["alive"]
    hit_now = torch.isfinite(best_t)
    limit = torch.minimum(maxt_primary, best_t)
    retire_primary = ~phase & _primary_exhausted(s, limit, walked_out)
    retire_shadow = phase & ((s["alive"] & hit_now) | walked_out)

    hit0 = retire_primary & hit_now
    poi = s["o"] + s["d"] * best_t[:, None]
    to_light = light - poi
    norm = vm.sqrt(vm.length2(to_light))[:, None]
    sdir = to_light / torch.where(norm > 0, norm, torch.ones_like(norm))
    skip = torch.zeros_like(hit0)
    if skip_dead_shadow:
        t9 = s["best_tri9"]
        a, b, c = t9[:, 0:3], t9[:, 3:6], t9[:, 6:9]
        if shade_serial:  # getNormalMod, Serial/geometry.h:234-240
            n = vm.cross(a - b, c - a)
        else:  # Parallel/geometry.cuh:160
            n = vm.cross(c - b, a - b)
        h = sdir - s["d"]
        e1s = vm.length2(a - b)
        e2s = vm.length2(c - a)
        m = _f32(2e-5, dev) * vm.sqrt(e1s * e2s)
        dead = (vm.dot(n, sdir) <= -m) & (vm.dot(n, h) <= -m)
        skip = hit0 & dead
        hit0 = hit0 & ~dead
    if serial_quirk:  # Serial/raytracer.cpp:106, away from the light
        sdir = -sdir
    new_o = torch.where(hit0[:, None], poi, s["o"])
    new_d = torch.where(hit0[:, None], sdir, s["d"])
    st0, s_entered = _slab_entry(grid, new_o, new_d,
                                 torch.full_like(best_t, float(np.float32(shadow_mint))),
                                 torch.full_like(best_t, _INF))
    done = ((retire_primary & ~hit_now) | (hit0 & ~s_entered) | skip | retire_shadow)
    in_shadow = retire_shadow & hit_now
    zi = torch.zeros_like(s["best_blk"])
    s = dict(
        s,
        o=new_o, d=new_d,
        phase=phase | hit0,
        gate=torch.where(hit0, _f32(shadow_gate, dev), s["gate"]),
        p_best_t=torch.where(retire_primary, best_t, s["p_best_t"]),
        p_best_blk=torch.where(retire_primary, s["best_blk"], s["p_best_blk"]),
        p_best_slot=torch.where(retire_primary, s["best_slot"], s["p_best_slot"]),
        best_t=torch.where(hit0, inf, best_t),
        best_blk=torch.where(hit0, zi, s["best_blk"]),
        best_slot=torch.where(hit0, zi, s["best_slot"]),
        t_cur=torch.where(hit0, st0, t_cur),
        # a shadow lane retires mid-cell at its first hit: stop its scan
        testing=testing & ~hit0 & ~done,
        cursor=torch.where(hit0, zi, s["cursor"]),
        alive=(s["alive"] | hit0) & ~done,
    )
    return s, dict(done=done, in_shadow=in_shadow)


def _slot_tri(grid, blk, slot, bt):
    n_slots = grid.slot_tri.shape[0]
    return grid.slot_tri[torch.clamp(blk * bt + slot, 0, n_slots - 1).long()]


def march_plain(
    rays: RayBatch, grid: PackedGridArrays, meta: PackedGridMeta,
    light_pos: Optional[torch.Tensor] = None, *, fused: bool = False,
    t_gate: float = 0.0, stop_on_first_hit: bool = False,
    shadow_gate: float = 1e-4, shadow_mint: float = 1e-4,
    serial_quirk: bool = False, skip_dead_shadow: bool = False,
    shade_serial: bool = False, probe_chain: int = 1,
    max_steps: Optional[int] = None,
    tested_out: Optional[torch.Tensor] = None,
    touched_out: Optional[torch.Tensor] = None,
    capped_out: Optional[torch.Tensor] = None,
) -> FusedTraceResult:
    """The lock-step march of every ray (`traverse_packed`, or with
    fused=True `traverse_packed_fused_shadow` plus the persistent wave's
    dead-shadow skip), in plain PyTorch.  A lane still alive after
    max_steps (default _default_max_steps, doubled when fused) keeps the
    record it has and is counted in capped_out.  tested_out (R,) i32
    receives the rows each ray tested, touched_out (n_blocks,) i32 ORs 1
    into rows whose header a probe read and 2 into rows tested."""
    if fused and stop_on_first_hit:
        raise ValueError("stop_on_first_hit (any-hit) cannot be fused with the "
                         "shadow rearm: the rearm point must be the nearest hit")
    if fused and light_pos is None:
        raise ValueError("the fused march needs light_pos")
    bt = meta.block_tris
    if max_steps is None:
        max_steps = _default_max_steps(meta) * (2 if fused else 1)
    o0 = rays.orig.to(torch.float32)
    d0 = rays.dirn.to(torch.float32)
    mint0 = rays.mint.to(torch.float32)
    maxt0 = rays.maxt.to(torch.float32)
    dev = o0.device
    r = o0.shape[0]
    inf = _f32(_INF, dev)
    t0, entered = _slab_entry(grid, o0, d0, mint0, maxt0)
    zf = torch.zeros((r,), dtype=torch.float32, device=dev)
    zi = torch.zeros((r,), dtype=torch.int32, device=dev)
    zb = torch.zeros((r,), dtype=torch.bool, device=dev)
    s = dict(o=o0, d=d0, gate=zf + _f32(t_gate, dev), alive=entered, testing=zb,
             t_cur=t0, t_exit_cell=zf, first_blk=zi, n_blk=zi, cursor=zi,
             best_t=zf + inf, best_blk=zi, best_slot=zi)
    need_tri9 = fused and skip_dead_shadow
    if fused:
        s.update(phase=zb, p_best_t=zf + inf, p_best_blk=zi, p_best_slot=zi)
        light = light_pos.to(device=dev, dtype=torch.float32)
    if need_tri9:
        s["best_tri9"] = torch.zeros((r, 9), dtype=torch.float32, device=dev)
    stats = None
    if tested_out is not None or touched_out is not None:
        touched = (torch.zeros((meta.n_blocks,), dtype=torch.int32, device=dev)
                   if touched_out is not None else None)
        stats = dict(tested=zi.clone(), touched=touched)
    shadow_hit = zb
    steps = zi
    invd = torch.reciprocal(d0)
    i = 0
    while i < max_steps and bool(s["alive"].any()):
        pre_alive = s["alive"]
        if fused:
            # shadow rays march unbounded; the primary's maxt stays its own
            maxt_lane = torch.where(s["phase"], inf, maxt0)
            invd = torch.reciprocal(s["d"])
        else:
            maxt_lane = maxt0
        s = _march_step(s, o=s["o"], d=s["d"], invd=invd, gate=s["gate"],
                        maxt=maxt_lane, grid=grid, meta=meta,
                        need_hit_tri=need_tri9, probe_chain=probe_chain, stats=stats)
        if fused:
            s, aux = _fused_retire_rearm(
                s, pre_alive=pre_alive, maxt_primary=maxt0, light=light,
                serial_quirk=serial_quirk, shadow_gate=shadow_gate,
                shadow_mint=shadow_mint, grid=grid,
                skip_dead_shadow=skip_dead_shadow, shade_serial=shade_serial)
            shadow_hit = shadow_hit | aux["in_shadow"]
        else:
            limit = torch.minimum(maxt0, s["best_t"])
            alive = s["alive"] & (s["testing"] | (s["t_cur"] <= limit))
            if stop_on_first_hit:
                # any-hit retirement can land mid-cell: stop the row scan
                alive = alive & ~torch.isfinite(s["best_t"])
                s["testing"] = s["testing"] & alive
            s["alive"] = alive
        steps = steps + pre_alive.to(torch.int32)
        i += 1

    if capped_out is not None:
        capped_out.fill_(int(s["alive"].sum()))
    if stats is not None:
        if tested_out is not None:
            tested_out.copy_(stats["tested"])
        if touched_out is not None:
            touched_out.copy_(stats["touched"])
    minus1 = torch.full_like(zi, -1)
    if not fused:
        hit = torch.isfinite(s["best_t"])
        tri = torch.where(hit, _slot_tri(grid, s["best_blk"], s["best_slot"], bt), minus1)
        return FusedTraceResult(hit=hit, t=s["best_t"], tri_id=tri, in_shadow=zb,
                                shadow_tri_id=minus1, steps=steps)
    phase = s["phase"]
    pt = torch.where(phase, s["p_best_t"], s["best_t"])
    pblk = torch.where(phase, s["p_best_blk"], s["best_blk"])
    pslot = torch.where(phase, s["p_best_slot"], s["best_slot"])
    # a shadow lane still marching at the cap with a blocker counts
    shadow = shadow_hit | (phase & torch.isfinite(s["best_t"]))
    hit = torch.isfinite(pt)
    tri = torch.where(hit, _slot_tri(grid, pblk, pslot, bt), minus1)
    stri = torch.where(shadow & phase, _slot_tri(grid, s["best_blk"], s["best_slot"], bt),
                       minus1)
    return FusedTraceResult(hit=hit, t=pt, tri_id=tri, in_shadow=shadow & hit,
                            shadow_tri_id=stri, steps=steps)


class _MarchParams(ctypes.Structure):
    """Mirror of `MarchParams` in csrc/packed_step.cuh (passed by value)."""

    _fields_ = [
        ("lower", ctypes.c_float * 3), ("upper", ctypes.c_float * 3),
        ("width", ctypes.c_float * 3), ("inv_width", ctypes.c_float * 3),
        ("light", ctypes.c_float * 3),
        ("probe_delta", ctypes.c_float), ("gate", ctypes.c_float),
        ("shadow_gate", ctypes.c_float), ("shadow_mint", ctypes.c_float),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("n_blocks", ctypes.c_int), ("block_tris", ctypes.c_int),
        ("row_lanes", ctypes.c_int), ("inline_layout", ctypes.c_int),
        ("n_slots", ctypes.c_int), ("fused", ctypes.c_int),
        ("stop_on_first_hit", ctypes.c_int), ("skip_dead", ctypes.c_int),
        ("shade_serial", ctypes.c_int), ("serial_quirk", ctypes.c_int),
        ("probe_chain", ctypes.c_int), ("max_steps", ctypes.c_int),
        ("n_rays", ctypes.c_int), ("n_work", ctypes.c_int),
    ]


class LaunchConsts(NamedTuple):
    """Host copies of the device values a packed kernel's launch passes by
    value, as Python floats: the grid's box, cell widths and inverse
    widths, the light and its intensity.  `render.renderer.prepare`
    reads them once; a wrapper given none reads them itself, a blocking
    copy each."""

    lower: tuple
    upper: tuple
    width: tuple
    inv_width: tuple
    light: tuple = (0.0, 0.0, 0.0)
    intensity: float = 0.0


def _host_vec3(x: torch.Tensor) -> tuple:
    return tuple(float(v) for v in x.detach().to("cpu", torch.float32))


def launch_consts(grid: PackedGridArrays, light_pos: Optional[torch.Tensor] = None,
                  light_intensity: Optional[torch.Tensor] = None) -> LaunchConsts:
    """Read the launch values of `grid` and the light from the device."""
    light = _host_vec3(light_pos) if light_pos is not None else (0.0, 0.0, 0.0)
    li = float(light_intensity) if light_intensity is not None else 0.0
    return LaunchConsts(lower=_host_vec3(grid.lower), upper=_host_vec3(grid.upper),
                        width=_host_vec3(grid.width), inv_width=_host_vec3(grid.inv_width),
                        light=light, intensity=li)


def _c_vec3(v) -> ctypes.Array:
    return (ctypes.c_float * 3)(*v)


def march_params(consts: LaunchConsts, meta: PackedGridMeta, **fields) -> _MarchParams:
    """A _MarchParams of the grid's box and the light from `consts`, the
    layout from `meta`, and the launch's other fields."""
    nx, ny, nz = meta.n_voxels
    return _MarchParams(
        lower=_c_vec3(consts.lower), upper=_c_vec3(consts.upper),
        width=_c_vec3(consts.width), inv_width=_c_vec3(consts.inv_width),
        light=_c_vec3(consts.light), probe_delta=meta.probe_delta, nx=nx, ny=ny, nz=nz,
        n_blocks=meta.n_blocks, block_tris=meta.block_tris, row_lanes=meta.row_lanes,
        inline_layout=int(meta.inline), **fields)


def march_cuda(
    rays: RayBatch, grid: PackedGridArrays, meta: PackedGridMeta,
    light_pos: Optional[torch.Tensor] = None, *, fused: bool = False,
    t_gate: float = 0.0, stop_on_first_hit: bool = False,
    shadow_gate: float = 1e-4, shadow_mint: float = 1e-4,
    serial_quirk: bool = False, skip_dead_shadow: bool = False,
    shade_serial: bool = False, probe_chain: int = 1,
    max_steps: Optional[int] = None,
    tested_out: Optional[torch.Tensor] = None,
    touched_out: Optional[torch.Tensor] = None,
    capped_out: Optional[torch.Tensor] = None,
    queue: Optional[torch.Tensor] = None, n_work: Optional[int] = None,
    iters_out: Optional[torch.Tensor] = None, passes_out: Optional[torch.Tensor] = None,
    consts: Optional[LaunchConsts] = None,
) -> FusedTraceResult:
    """Kernel C on CUDA tensors; the plain version's records.

    One lane a queue position marches that ray, and the warp shares out
    the row tests of every step; the card's block scheduler keeps the
    lanes resident, so the launch has no width to set (the JAX wave width
    has no counterpart here).  Positions [0, n_work) of `queue` (ray ids;
    every ray in order when None) are marched; rays never served keep the
    miss record.  iters_out (1,) i32 receives the most march steps one
    lane ran; passes_out (1,) i32 the number of tested slots that passed
    the barycentric test (chip_smoke.py counts the operation bound from
    it).  consts: the grid's and the light's launch values held on the
    host (`launch_consts`; read from the device here when None)."""
    if not rays.orig.is_cuda:
        raise ValueError("march_cuda takes CUDA tensors")
    if fused and stop_on_first_hit:
        raise ValueError("stop_on_first_hit cannot be fused with the shadow rearm")
    if fused and light_pos is None:
        raise ValueError("the fused march needs light_pos")
    if probe_chain > 1 and meta.inline:
        raise ValueError("probe_chain > 1 serves the blocks layout only")
    dev = rays.orig.device
    r = rays.count
    orig, dirn, mint, maxt = (x.to(torch.float32).contiguous() for x in rays)
    blocks = grid.blocks.to(torch.float32).contiguous()
    cell_info = grid.cell_info.to(torch.int32).contiguous()
    slot_tri = grid.slot_tri.to(torch.int32).contiguous()
    if blocks.shape != (meta.n_blocks, meta.row_lanes):
        raise ValueError("blocks does not match the meta")
    for name, buf, shape in (("tested_out", tested_out, (r,)),
                             ("touched_out", touched_out, (meta.n_blocks,)),
                             ("capped_out", capped_out, (1,)),
                             ("iters_out", iters_out, (1,)),
                             ("passes_out", passes_out, (1,))):
        if buf is not None and (buf.dtype != torch.int32 or not buf.is_contiguous()
                                or tuple(buf.shape) != shape or buf.device != dev):
            raise ValueError(f"{name} must be a contiguous {shape} int32 CUDA tensor")
    for buf in (touched_out, capped_out, iters_out, passes_out):
        if buf is not None:
            buf.zero_()
    hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    t = torch.full((r,), _INF, dtype=torch.float32, device=dev)
    tri_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    in_shadow = torch.zeros((r,), dtype=torch.bool, device=dev)
    shadow_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    steps = torch.zeros((r,), dtype=torch.int32, device=dev)
    if tested_out is not None:
        tested_out.zero_()
    res = FusedTraceResult(hit=hit, t=t, tri_id=tri_id, in_shadow=in_shadow,
                           shadow_tri_id=shadow_tri, steps=steps)
    if r == 0:
        return res
    if max_steps is None:
        max_steps = _default_max_steps(meta) * (2 if fused else 1)
    if queue is not None:
        queue = queue.to(device=dev, dtype=torch.int32).contiguous()
        n_work = queue.shape[0] if n_work is None else int(n_work)
        if n_work > queue.shape[0]:
            raise ValueError("n_work exceeds the queue")
    elif n_work is None:
        n_work = r
    if consts is None:
        consts = launch_consts(grid, light_pos)
    if light_pos is None:
        consts = consts._replace(light=(0.0, 0.0, 0.0))
    params = march_params(
        consts, meta, gate=t_gate, shadow_gate=shadow_gate, shadow_mint=shadow_mint,
        n_slots=slot_tri.shape[0], fused=int(fused),
        stop_on_first_hit=int(stop_on_first_hit), skip_dead=int(skip_dead_shadow),
        shade_serial=int(shade_serial), serial_quirk=int(serial_quirk),
        probe_chain=int(probe_chain), max_steps=int(max_steps), n_rays=r,
        n_work=int(n_work),
    )

    def ptr(x):
        return x.data_ptr() if x is not None else None

    fn = _build.library("packed_march").packed_march_launch
    fn.restype = ctypes.c_int
    p = ctypes.c_void_p
    fn.argtypes = [_MarchParams] + [p] * 20
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(params, orig.data_ptr(), dirn.data_ptr(), mint.data_ptr(),
                 maxt.data_ptr(), cell_info.data_ptr(), blocks.data_ptr(),
                 slot_tri.data_ptr(), ptr(queue), hit.data_ptr(), t.data_ptr(),
                 tri_id.data_ptr(), in_shadow.data_ptr(), shadow_tri.data_ptr(),
                 steps.data_ptr(), ptr(tested_out), ptr(touched_out), ptr(capped_out),
                 ptr(passes_out), ptr(iters_out), stream)
    _build.check(err, "packed_march")
    march_cuda.launches += 1
    return res


march_cuda.launches = 0


def march(rays: RayBatch, grid: PackedGridArrays, meta: PackedGridMeta,
          light_pos: Optional[torch.Tensor] = None, consts: Optional[LaunchConsts] = None,
          **kw) -> FusedTraceResult:
    """Kernel C (one lane per ray, in order) for CUDA tensors, the plain
    version for CPU tensors; consts are the kernel's host-held launch
    values."""
    if rays.orig.is_cuda:
        return march_cuda(rays, grid, meta, light_pos, consts=consts, **kw)
    if rays.orig.device.type != "cpu":
        raise ValueError(f"unsupported device {rays.orig.device}")
    return march_plain(rays, grid, meta, light_pos, **kw)


def _max_steps_of(meta, max_steps, unroll):
    """The JAX loop runs ceil(max_steps / unroll) iterations of `unroll`
    steps; unroll changes nothing else."""
    if max_steps is None:
        max_steps = _default_max_steps(meta)
    return -(-max_steps // unroll) * unroll


def traverse_packed(
    rays: RayBatch, grid: PackedGridArrays, meta: PackedGridMeta, *,
    t_gate: float = 0.0, stop_on_first_hit: bool = False,
    max_steps: Optional[int] = None, unroll: int = 1, probe_chain: int = 1,
    consts: Optional[LaunchConsts] = None,
) -> PackedTraceResult:
    """Nearest hit (or any hit with stop_on_first_hit) of every ray over
    the packed grid (traverse_packed.py:497)."""
    res = march(rays, grid, meta, t_gate=t_gate, stop_on_first_hit=stop_on_first_hit,
                probe_chain=probe_chain, max_steps=_max_steps_of(meta, max_steps, unroll),
                consts=consts)
    return PackedTraceResult(any_pass=res.hit, hit=res.hit, t=res.t,
                             tri_id=res.tri_id, steps=res.steps)


def traverse_packed_fused_shadow(
    rays: RayBatch, grid: PackedGridArrays, meta: PackedGridMeta,
    light_pos: torch.Tensor, *, primary_gate: float = 0.0,
    shadow_gate: float = 1e-4, shadow_mint: float = 1e-4,
    serial_quirk: bool = False, max_steps: Optional[int] = None,
    consts: Optional[LaunchConsts] = None,
) -> FusedTraceResult:
    """Primary nearest hit + shadow occlusion in one march: a lane rearms
    in place as its shadow ray when its primary retires
    (traverse_packed.py:599)."""
    if max_steps is None:
        max_steps = 2 * _default_max_steps(meta)
    return march(rays, grid, meta, light_pos, fused=True, t_gate=primary_gate,
                 shadow_gate=shadow_gate, shadow_mint=shadow_mint,
                 serial_quirk=serial_quirk, max_steps=max_steps, consts=consts)


__all__ = [
    "LaunchConsts", "PackedTraceResult", "FusedTraceResult", "chord_keys", "launch_consts",
    "march", "march_cuda",
    "march_plain", "traverse_packed", "traverse_packed_fused_shadow",
]
