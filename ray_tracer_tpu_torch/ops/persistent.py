"""The persistent wave: every ray of a batch through the packed march.

Counterpart of `ray_tracer_tpu/ops/persistent.py:persistent_trace`, the
TPU translation of the CUDA reference's persistent threads
(Parallel/raytracer.cu:177-233): a wave of W lanes pops rays from a work
queue, marches each through the shared DDA core, optionally rearms it as
its own shadow ray, and scatters one record per ray.  A ray's record
depends on that ray alone, never on the schedule (tests/test_persistent.py
pins that in JAX), so:

  * on CUDA tensors the wave is one launch of kernel C over the queue,
    one lane per queue position, which the card's block scheduler keeps
    resident on every SM; that measured faster on the H100 than resident
    lanes popping positions from an atomic counter (PERF.md);
  * on CPU tensors it is the plain lock-step march over the queued rays.

Knobs: `compact` and `order_keys`/`order_classes` build the queue exactly
as JAX does (live rays only; difficulty classes first) and so decide
which rays are served and in what order.  `wave`, `pump`,
`refill_retries` and `probe_chain` on the inline layout shape only the
JAX lock-step loop: the card sizes its launch by itself, and a lane that
marches one ray at a time has no scatter round to pump and no lane to
refill, so they have no effect here, on the card or on the CPU.
`camera` takes the batch from `camera_rays` (which the JAX package pins
bitwise equal to its `camera_ray_at` regeneration); `rays` then supplies
only the count.  `need_t`, `need_steps`, `need_shadow_tri`
and `return_iters` keep their JAX meaning; `return_iters` counts, on the
card, the most march steps one lane ran, and on the CPU the lock-step
iterations.  A ray still marching after max_iters steps (default: the
JAX per-ray bound, doubled when fused) keeps its partial record and is
counted in `capped_out`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tracer_tpu_torch.accel.packed import PackedGridArrays, PackedGridMeta
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.ops.traverse_packed import (
    FusedTraceResult,
    LaunchConsts,
    _default_max_steps,
    _slab_entry,
    march_cuda,
    march_plain,
)

_INF = float("inf")


def work_queue(rays: RayBatch, grid: PackedGridArrays, *, compact: bool,
               order_keys: Optional[torch.Tensor], order_classes: int = 4):
    """The JAX package's live-first work queue (persistent.py:203-264):
    None (arrival order, every ray) or (work_ids (R,) i32, n_work).  With
    order_keys, rays pop in ascending key class (M = order_classes linear
    classes over the live key range, a stable counting sort), rays that
    never enter last; with compact, only rays that enter the grid are
    queued."""
    if not compact and order_keys is None:
        return None
    r = rays.count
    dev = rays.orig.device
    _, live = _slab_entry(grid, rays.orig.to(torch.float32), rays.dirn.to(torch.float32),
                          rays.mint.to(torch.float32), rays.maxt.to(torch.float32))
    ar = torch.arange(r, dtype=torch.int32, device=dev)
    if order_keys is not None:
        key = torch.where(live, order_keys.to(torch.float32),
                          torch.full((r,), _INF, dtype=torch.float32, device=dev))
        m = order_classes
        finite = torch.isfinite(key)
        kmin = torch.where(finite, key, torch.full_like(key, _INF)).amin()
        kmax = torch.where(finite, key, torch.full_like(key, -_INF)).amax()
        span = torch.clamp(kmax - kmin, min=1e-20)
        q = ((key - kmin) / span * m)
        q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
        q = torch.clamp(q.to(torch.int32), 0, m - 1)
        q = torch.where(finite, q, torch.full_like(q, m))  # never-entering rays last
        ranks = torch.zeros((r,), dtype=torch.int64, device=dev)
        base = 0
        for c in range(m + 1):
            sel = q == c
            pos = torch.cumsum(sel.to(torch.int64), 0) - 1
            ranks = torch.where(sel, base + pos, ranks)
            base = base + int(pos[-1]) + 1 if r else base
        work_ids = torch.zeros((r,), dtype=torch.int32, device=dev)
        work_ids[ranks] = ar
        n_work = int(finite.sum()) if compact else r
    else:
        pos = torch.cumsum(live.to(torch.int64), 0) - 1
        n_work = int(pos[-1]) + 1 if r else 0
        work_ids = ar[live]
    return work_ids, n_work


def persistent_trace(
    rays: RayBatch,
    grid: PackedGridArrays,
    meta: PackedGridMeta,
    light_pos: Optional[torch.Tensor] = None,
    *,
    wave: int = 65536,
    t_gate: float = 0.0,
    fuse_shadow: bool = False,
    shadow_gate: float = 1e-4,
    shadow_mint: float = 1e-4,
    serial_quirk: bool = False,
    stop_on_first_hit: bool = False,
    max_iters: Optional[int] = None,
    return_iters: bool = False,
    need_shadow_tri: bool = False,
    need_steps: bool = False,
    need_t: bool = True,
    camera=None,
    spp: int = 1,
    pump: int = 1,
    compact: bool = False,
    order_keys: Optional[torch.Tensor] = None,
    order_classes: int = 4,
    refill_retries: Optional[int] = None,
    shadow_skip_dead: bool = False,
    shade_serial: bool = False,
    probe_chain: int = 1,
    capped_out: Optional[torch.Tensor] = None,
    touched_out: Optional[torch.Tensor] = None,
    tested_out: Optional[torch.Tensor] = None,
    consts: Optional[LaunchConsts] = None,
):
    """March every ray through the packed grid as a persistent wave;
    optionally fuse each ray's shadow query.  Returns an (R,)-aligned
    FusedTraceResult (and the iteration count with return_iters).  With
    fuse_shadow=False the shadow fields are all clear; shadow_tri_id is -1
    unless need_shadow_tri, steps 0 unless need_steps, t a 0/inf hit
    placeholder unless need_t.  consts: kernel C's host-held launch
    values (`launch_consts`), on the card."""
    del wave, pump, refill_retries  # shape the JAX lock-step loop only
    if fuse_shadow:
        if light_pos is None:
            raise ValueError("fuse_shadow needs light_pos")
        if stop_on_first_hit:
            raise ValueError("stop_on_first_hit (any-hit) cannot be fused with the "
                             "shadow rearm: the rearm point must be the nearest hit")
    if camera is not None:
        from ray_tracer_tpu_torch.ops.camera import camera_rays

        if rays.count != camera.width * camera.height * spp * spp:
            raise ValueError("rays must hold one ray per camera subsample")
        rays = camera_rays(camera, spp=spp, device=grid.lower.device)
    if grid.slot_tri.shape[0] >= (1 << 30):
        raise ValueError("slot index must fit in 30 bits")
    r = rays.count
    dev = rays.orig.device
    per_ray = _default_max_steps(meta) * (2 if fuse_shadow else 1)
    max_steps = per_ray if max_iters is None else int(max_iters)
    kw = dict(fused=fuse_shadow, t_gate=t_gate, stop_on_first_hit=stop_on_first_hit,
              shadow_gate=shadow_gate, shadow_mint=shadow_mint,
              serial_quirk=serial_quirk, skip_dead_shadow=fuse_shadow and shadow_skip_dead,
              shade_serial=shade_serial, probe_chain=1 if meta.inline else probe_chain,
              max_steps=max_steps, touched_out=touched_out, capped_out=capped_out)
    queue = work_queue(rays, grid, compact=compact, order_keys=order_keys,
                       order_classes=order_classes)
    iters = None
    if rays.orig.is_cuda:
        iters_out = torch.zeros((1,), dtype=torch.int32, device=dev) if return_iters else None
        res = march_cuda(rays, grid, meta, light_pos, queue=None if queue is None else queue[0],
                         n_work=None if queue is None else queue[1],
                         iters_out=iters_out, tested_out=tested_out, consts=consts, **kw)
        if return_iters:
            iters = int(iters_out.item())
    elif dev.type == "cpu":
        if queue is None:
            res = march_plain(rays, grid, meta, light_pos, tested_out=tested_out, **kw)
            if return_iters:
                iters = int(res.steps.max()) if r else 0
        else:
            res = _march_queued(rays, grid, meta, light_pos, queue, tested_out, kw)
            if return_iters:
                iters = int(res.steps.max()) if r else 0
    else:
        raise ValueError(f"unsupported device {dev}")

    hit = res.hit
    t = res.t if need_t else torch.where(hit, torch.zeros_like(res.t),
                                         torch.full_like(res.t, _INF))
    out = FusedTraceResult(
        hit=hit, t=t, tri_id=res.tri_id, in_shadow=res.in_shadow,
        shadow_tri_id=(res.shadow_tri_id if need_shadow_tri
                       else torch.full_like(res.tri_id, -1)),
        steps=res.steps if need_steps else torch.zeros_like(res.steps),
    )
    return (out, iters) if return_iters else out


def _march_queued(rays, grid, meta, light_pos, queue, tested_out, kw):
    """The plain march over the queued rays; rays the queue never serves
    keep the miss record."""
    work_ids, n_work = queue
    r = rays.count
    dev = rays.orig.device
    ids = work_ids[:n_work].long()
    sub = RayBatch(*(x[ids] for x in rays))
    sub_tested = (torch.zeros((n_work,), dtype=torch.int32, device=dev)
                  if tested_out is not None else None)
    part = march_plain(sub, grid, meta, light_pos, tested_out=sub_tested, **kw)
    full = FusedTraceResult(
        hit=torch.zeros((r,), dtype=torch.bool, device=dev),
        t=torch.full((r,), _INF, dtype=torch.float32, device=dev),
        tri_id=torch.full((r,), -1, dtype=torch.int32, device=dev),
        in_shadow=torch.zeros((r,), dtype=torch.bool, device=dev),
        shadow_tri_id=torch.full((r,), -1, dtype=torch.int32, device=dev),
        steps=torch.zeros((r,), dtype=torch.int32, device=dev),
    )
    for dst, src in zip(full, part):
        dst[ids] = src
    if tested_out is not None:
        tested_out.zero_()
        tested_out[ids] = sub_tested
    return full
