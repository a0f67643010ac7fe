"""Inverse rendering: fit scene parameters to a target image.

Counterpart of `ray_tracer_tpu/opt/fit.py` (`SceneParams`, `split_scene`,
`merge_scene`, `pixel_major_rays`, `image_loss`, `make_train_step`,
`RingSceneArrays`, `make_ring_train_step`, `fit`), on one device,
data-parallel over a mesh's "rays" axis, or with the geometry sharded by
ring orbits over its "tris" axis.
Pixel-loss gradients with respect to the vertices, the materials, the
light and the scene's images flow through `render_rays`: the traversal
is a no-grad island that finds the hit topology, and t, the normals and
the shading are recomputed from it under autograd.  A step is the
forward render, the L2 pixel loss, its backward and a `torch.optim`
update (Adam or SGD, with optax's defaults).

Where the JAX package differs:

  * the whole camera batch renders in one call (the JAX package pads
    rays to tiles for the TPU's static shapes; rays are independent, so
    the colors are the same);
  * a grid rebuild is `prepare` at the built meta, without the JAX
    package's padding to a static meta (the port has no jit to keep);
  * `init` returns the params it made trainable with the optimizer, and
    the optimizer updates them in place;
  * with `mesh=` every rank renders its contiguous shard of the rays and
    runs its own backward; the loss is the all-reduced sum of the local
    sums and the gradients are summed (`allreduce_gradients`) before the
    optimizer steps, so every rank holds the same parameters after every
    step (the JAX package's psum inside shard_map);
  * the tris-sharded ring step (`make_ring_train_step`) trains through
    ring orbits (`parallel.shard.ring_loss`): each rank holds a slice of
    the faces, the carried vertices' gradients come back along the ring,
    and the loss and gradients are summed over both mesh axes before the
    optimizer steps (the JAX package's psum over both axes).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional, Tuple

import torch

from ray_tracer_tpu_torch.config import SceneConfig
from ray_tracer_tpu_torch.models.materials import MaterialTable
from ray_tracer_tpu_torch.models.scenes import Scene
from ray_tracer_tpu_torch.ops.camera import camera_rays, fold_subsamples
from ray_tracer_tpu_torch.ops.traverse import dda_tables, vertex_table
from ray_tracer_tpu_torch.ops.traverse_packed import LaunchConsts, launch_consts
from ray_tracer_tpu_torch.core import vecmath as vm
from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.parallel.collectives import all_reduce_sum, allreduce_gradients
from ray_tracer_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tracer_tpu_torch.parallel.multihost import is_host0
from ray_tracer_tpu_torch.parallel.shard import _pad_to, pad_rays
from ray_tracer_tpu_torch.render.renderer import prepare, render_rays

log = logging.getLogger("ray_tracer_tpu_torch.fit")

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class SceneParams(NamedTuple):
    """The differentiable leaves of a Scene, in the JAX package's field
    order (a checkpoint's p_i leaves follow it).  The optional fields are
    None where the scene lacks them."""

    verts: torch.Tensor
    base_color: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    spec_alpha: torch.Tensor
    ka: torch.Tensor
    km: torch.Tensor
    light_pos: torch.Tensor
    light_intensity: torch.Tensor
    texture_image: Optional[torch.Tensor] = None
    extra_light_pos: Optional[torch.Tensor] = None
    extra_light_intensity: Optional[torch.Tensor] = None
    env_image: Optional[torch.Tensor] = None


def split_scene(scene: Scene) -> SceneParams:
    m = scene.materials
    return SceneParams(
        verts=scene.verts, base_color=m.base_color, kd=m.kd, ks=m.ks,
        spec_alpha=m.spec_alpha, ka=m.ka, km=m.km,
        light_pos=scene.light_pos, light_intensity=scene.light_intensity,
        texture_image=scene.texture_image, extra_light_pos=scene.extra_light_pos,
        extra_light_intensity=scene.extra_light_intensity, env_image=scene.env_image,
    )


def merge_scene(params: SceneParams, scene: Scene) -> Scene:
    """The scene with params' leaves; its topology, uvs and glass tables
    pass through untrained."""
    return scene._replace(
        verts=params.verts,
        materials=MaterialTable(
            base_color=params.base_color, kd=params.kd, ks=params.ks,
            spec_alpha=params.spec_alpha, ka=params.ka, km=params.km,
            reflective=scene.materials.reflective,
        ),
        light_pos=params.light_pos, light_intensity=params.light_intensity,
        texture_image=params.texture_image, extra_light_pos=params.extra_light_pos,
        extra_light_intensity=params.extra_light_intensity, env_image=params.env_image,
    )


def detached(params: SceneParams) -> SceneParams:
    return SceneParams(*(None if x is None else x.detach() for x in params))


def _colors(params, scene, grid, meta, cfg, dda, consts) -> torch.Tensor:
    """(H*W, 3) colors through `render_rays`: the spp^2 subsample batches
    rendered as one and averaged in subsample order.  At spp 1 the batch
    is the camera's whole batch in pixel order, so the persistent wave
    makes its rays from the pixel index (the camera refill)."""
    rcfg = cfg.render
    spp = rcfg.spp
    rays = camera_rays(cfg.camera, dtype=_DTYPES[rcfg.dtype], spp=spp,
                       device=params.verts.device)
    persistent = rcfg.traversal == "packed" and rcfg.scheduler == "persistent"
    colors = render_rays(rays, merge_scene(params, scene), grid, meta, rcfg,
                         camera_cfg=cfg.camera if persistent and spp == 1 else None,
                         dda=dda, consts=consts)
    if spp > 1:
        colors = fold_subsamples(colors.reshape(spp * spp, -1, 3).unbind(0))
    return colors


def pixel_major_rays(rays: RayBatch, r: int, spp: int, padded: int) -> RayBatch:
    """Regroup a subsample-major camera batch (index s*r + pixel) pixel
    major (index pixel*spp^2 + s) and pad it by whole pixels to `padded`,
    so that a contiguous shard holds every subsample of its pixels.
    Padding pixels get inf origins, by which the loss masks them."""
    fills = dict(orig=float("inf"), dirn=1.0, mint=0.0, maxt=0.0)
    k = spp * spp

    def one(x, fill):
        x2 = x.reshape((k, r) + x.shape[1:]).transpose(0, 1)
        if padded != r:
            x2 = torch.cat([x2, torch.full((padded - r,) + x2.shape[1:], fill, dtype=x.dtype,
                                           device=x.device)])
        return x2.reshape((padded * k,) + x2.shape[2:]).contiguous()

    return RayBatch(*(one(getattr(rays, f), fills[f]) for f in RayBatch._fields))


def _residual(colors, target) -> torch.Tensor:
    return vm.div_scalar(colors - target.reshape(-1, 3).to(colors.dtype), 255.0)


def image_loss(params: SceneParams, scene: Scene, grid, meta, cfg: SceneConfig,
               target: torch.Tensor, dda=None, consts=None) -> torch.Tensor:
    """Mean squared pixel error in linear color, normalized by 255
    (ray_tracer_tpu/opt/fit.py:147-161); spp-averaged as `render` is.
    dda and consts are kernel B's tables and kernel C's launch values
    for the card (derived by the wrappers when not given)."""
    d = _residual(_colors(params, scene, grid, meta, cfg, dda, consts), target)
    return torch.mean(d * d)


def _trainable_fields(params: SceneParams, trainable) -> Tuple[str, ...]:
    names = SceneParams._fields if trainable is None else trainable
    return tuple(f for f in SceneParams._fields if f in names and getattr(params, f) is not None)


def _make_optimizer(name: str, lr: float, tensors) -> torch.optim.Optimizer:
    """optax.adam / optax.sgd with their defaults."""
    if name == "adam":
        return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    if name == "sgd":
        return torch.optim.SGD(tensors, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


def _launch_tables(cfg: SceneConfig, params: SceneParams, scene: Scene, grid, fields, dda,
                   consts):
    """Kernel B's tables and kernel C's launch values for this step on the
    card: B's vertex rows follow the current verts when they train (the
    JAX traversal takes the current vertices over the last rebuild's
    cells), C's light the current light when it trains (the packed rows
    keep the last rebuild's vertices, as the JAX package's do)."""
    if not params.verts.is_cuda:
        return None, None
    rcfg = cfg.render
    if rcfg.traversal == "csr" and (dda is None or "verts" in fields):
        v, faces = params.verts.detach(), scene.faces
        dda = dda_tables(grid, vertex_table(v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]))
    if rcfg.traversal == "packed":
        if consts is None:
            consts = launch_consts(grid, params.light_pos, params.light_intensity)
        elif "light_pos" in fields or "light_intensity" in fields:
            consts = consts._replace(
                light=tuple(float(x) for x in params.light_pos.detach().cpu()),
                intensity=float(params.light_intensity.detach()))
    return dda, consts


def make_train_step(meta, cfg: SceneConfig, optimizer: str = "adam", lr: float = 1e-2,
                    mesh=None, axis: str = "rays",
                    trainable: Optional[Tuple[str, ...]] = None):
    """-> (step_fn, init_fn).  init_fn(params) -> (params, opt_state): the
    trainable fields become leaf tensors that require grad (copies; the
    others are left as given, the port's stop_gradient) and opt_state is
    the torch optimizer over them.  step_fn(params, opt_state, scene,
    grid, target, dda=None, consts=None) -> (params, opt_state, loss) over
    the grid of `meta`: the render, the loss sum(d^2) / (3 H W), its
    backward and the update (in place).  dda / consts: the grid's kernel B tables / kernel C
    launch values from `prepare` (refreshed each step where the trained
    fields move them).

    With `mesh`, the rays are sharded over its `axis` (every rank calls
    the step with the same arguments): the batch padded to a multiple of
    the shards (pixel-major by whole pixels at spp > 1,
    `pixel_major_rays`), each rank rendering its contiguous shard without
    the camera refill and masking the padding by its inf origins; the loss
    is the all-reduced sum of the local sums over 3 H W, and the gradients
    are summed over the axis before the update.

    Optimizing `verts` moves geometry out of the grid: rebuild it between
    steps (`fit`'s rebuild_grid_every)."""
    if trainable is not None:
        unknown = set(trainable) - set(SceneParams._fields)
        if unknown:
            raise ValueError(f"unknown trainable fields {sorted(unknown)}")
        trainable = tuple(sorted(trainable))
    r = cfg.camera.height * cfg.camera.width

    def init(params: SceneParams):
        fields = _trainable_fields(params, trainable)
        params = params._replace(**{f: getattr(params, f).detach().clone().requires_grad_(True)
                                    for f in fields})
        return params, _make_optimizer(optimizer, lr, [getattr(params, f) for f in fields])

    def step(params: SceneParams, opt_state, scene: Scene, grid, target, dda=None,
             consts=None):
        fields = _trainable_fields(params, trainable)
        dda, consts = _launch_tables(cfg, params, scene, grid, fields, dda, consts)
        opt_state.zero_grad(set_to_none=True)
        d = _residual(_colors(params, scene, grid, meta, cfg, dda, consts), target)
        loss = vm.div_scalar(torch.sum(d * d), float(3 * r))
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    if mesh is None:
        return step, init
    n = axis_size(mesh, axis)
    padded = _pad_to(r, n)
    k = cfg.render.spp * cfg.render.spp
    lo = axis_index(mesh, axis) * (padded // n)
    hi = lo + padded // n  # this rank's pixels [lo, hi) of the padded batch

    def sharded_step(params: SceneParams, opt_state, scene: Scene, grid, target, dda=None,
                     consts=None):
        fields = _trainable_fields(params, trainable)
        dda, consts = _launch_tables(cfg, params, scene, grid, fields, dda, consts)
        opt_state.zero_grad(set_to_none=True)
        rcfg = cfg.render
        rays = camera_rays(cfg.camera, dtype=_DTYPES[rcfg.dtype], spp=rcfg.spp,
                           device=params.verts.device)
        rays = pad_rays(rays, padded) if k == 1 else pixel_major_rays(rays, r, rcfg.spp,
                                                                       padded)
        mine = rays.slice(lo * k, hi * k)
        colors = render_rays(mine, merge_scene(params, scene), grid, meta, rcfg, dda=dda,
                             consts=consts)
        if k > 1:  # every subsample of a pixel is local, summed in order
            colors = fold_subsamples(colors.reshape(-1, k, 3).unbind(1))
        tgt = target.reshape(-1, 3).to(colors.dtype)
        if padded != r:
            # padding pixels render as the background; pad the target with
            # it, and mask them by their inf origins (with an environment
            # map a padding lane sees a lookup, not the background)
            bg = torch.tensor(rcfg.background, dtype=tgt.dtype, device=tgt.device)
            tgt = torch.cat([tgt, bg.expand(padded - r, 3)])
        d = _residual(colors, tgt[lo:hi])
        if padded != r:
            po = mine.orig if k == 1 else mine.orig.reshape(-1, k, 3)[:, 0, :]
            d = torch.where(torch.isfinite(po[:, :1]), d, torch.zeros_like(d))
        local = torch.sum(d * d)
        vm.div_scalar(local, float(3 * r)).backward()
        leaves = [getattr(params, f) for f in fields]  # the same list on every rank
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        for p, g in zip(leaves, allreduce_gradients(grads, mesh, axis)):
            p.grad = g
        opt_state.step()
        group = mesh.get_group(axis)
        return params, opt_state, vm.div_scalar(all_reduce_sum(local.detach(), group),
                                                float(3 * r))

    return sharded_step, init


class RingSceneArrays(NamedTuple):
    """The ring step's per-step inputs that do not train: the faces and
    material ids padded to the shard multiple (padding faces are point
    triangles at vertex 0), the reflective flags, and the ring grids
    (`parallel.shard.build_ring_shard`; None for all-pairs hops), swapped
    after a rebuild over moved vertices."""

    faces: torch.Tensor  # (fp, 3)
    fmat: torch.Tensor  # (fp,)
    reflective: torch.Tensor  # (M,) bool
    garr: Optional[object] = None  # the RingGrids, or None


def _psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for axis in axes:
        x = all_reduce_sum(x, mesh.get_group(axis))
    return x


def make_ring_train_step(prep, mesh, rays_axis: Optional[str] = "rays",
                         tris_axis: str = "tris", optimizer: str = "adam", lr: float = 1e-2,
                         trainable: Optional[Tuple[str, ...]] = None, ring_grids=None):
    """The train step with the geometry sharded over `tris_axis` (JAX
    opt/fit.py:300-403) -> (step_fn, init_fn, ring_scene).

    init_fn(params) -> (params, opt_state), as `make_train_step`'s;
    step_fn(params, opt_state, ring_scene, target) -> (params, opt_state,
    loss).  Every rank calls it with the same arguments: the camera rays
    (pixel-major at spp > 1, `pixel_major_rays`) are dealt over both axes,
    each rank's loss share runs the ring (`parallel.shard.ring_loss`) and
    its backward, and the loss sum(d^2) / (3 H W) and the gradients are
    summed over both axes before the update, so every rank holds the same
    parameters.  When verts train, rebuild ring_scene.garr with
    `build_ring_shard` between steps."""
    from ray_tracer_tpu_torch.parallel.shard import (
        _ring_faces,
        _RingDeal,
        build_ring_shard,
        ring_loss,
    )

    if trainable is not None:
        unknown = set(trainable) - set(SceneParams._fields)
        if unknown:
            raise ValueError(f"unknown trainable fields {sorted(unknown)}")
        trainable = tuple(sorted(trainable))
    cfg, scene = prep.cfg, prep.scene
    rcfg = cfg.render
    faces, fmat = _ring_faces(scene, axis_size(mesh, tris_axis))
    garr = None
    if rcfg.traversal == "packed":
        garr = build_ring_shard(prep, mesh, tris_axis) if ring_grids is None else ring_grids
        if garr.fp != faces.shape[0]:
            raise ValueError("ring_grids were built for a different shard count")
    ring_scene = RingSceneArrays(faces=faces, fmat=fmat,
                                 reflective=scene.materials.reflective, garr=garr)
    r = cfg.camera.height * cfg.camera.width
    k = rcfg.spp * rcfg.spp
    axes = (tris_axis, rays_axis) if rays_axis else (tris_axis,)

    def init(params: SceneParams):
        fields = _trainable_fields(params, trainable)
        params = params._replace(**{f: getattr(params, f).detach().clone().requires_grad_(True)
                                    for f in fields})
        return params, _make_optimizer(optimizer, lr, [getattr(params, f) for f in fields])

    def step(params: SceneParams, opt_state, ring_scene: RingSceneArrays, target):
        fields = _trainable_fields(params, trainable)
        opt_state.zero_grad(set_to_none=True)
        deal = _RingDeal(r, mesh, rays_axis, tris_axis)
        rays = camera_rays(cfg.camera, dtype=_DTYPES[rcfg.dtype], spp=rcfg.spp,
                           device=params.verts.device)
        rays = (pad_rays(rays, deal.padded) if k == 1
                else pixel_major_rays(rays, r, rcfg.spp, deal.padded))
        mine = rays.slice(deal.lo * k, (deal.lo + deal.per) * k)
        tgt = target.reshape(-1, 3)
        if deal.padded != r:
            bg = torch.tensor(rcfg.background, dtype=tgt.dtype, device=tgt.device)
            tgt = torch.cat([tgt, bg.expand(deal.padded - r, 3)])
        p = params._replace(**{f: getattr(params, f).detach() for f in SceneParams._fields
                               if f not in fields and getattr(params, f) is not None})
        local = ring_loss(p, ring_scene.faces, ring_scene.fmat, ring_scene.reflective, mine,
                          tgt[deal.lo:deal.lo + deal.per], cfg, mesh, rays_axis, tris_axis,
                          ring_grids=ring_scene.garr)
        vm.div_scalar(local, float(3 * r)).backward()
        leaves = [getattr(params, f) for f in fields]
        grads = [torch.zeros_like(q) if q.grad is None else q.grad for q in leaves]
        for axis in axes:
            grads = allreduce_gradients(grads, mesh, axis)
        for q, g in zip(leaves, grads):
            q.grad = g
        opt_state.step()
        return params, opt_state, vm.div_scalar(_psum(local.detach(), mesh, axes), float(3 * r))

    return step, init, ring_scene


def _rebuild(prep, params: SceneParams):
    """`prepare` over the current (detached) parameters at the first
    build's row width and layout: a new grid, packed grid, kernel B's
    tables and kernel C's launch values (a stale one would trace the old
    grid)."""
    cfg = prep.cfg
    if prep.packed is not None:
        m = prep.packed.meta
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, packed_block_tris=m.block_tris,
            grid_layout="inline" if m.inline else "blocks"))
    return prepare(cfg, scene=merge_scene(detached(params), prep.scene))._replace(
        scene=prep.scene)


def _grid_of(prep):
    if prep.cfg.render.traversal == "packed":
        return prep.packed.arrays, prep.packed.meta
    return prep.grid.arrays, prep.grid.meta


def fit(prep, target: torch.Tensor, steps: int = 100, lr: float = 1e-2,
        optimizer: str = "adam", mesh=None, axis: str = "rays",
        trainable: Optional[Tuple[str, ...]] = None, rebuild_grid_every: int = 0,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 50,
        resume: bool = False, log_every: int = 10) -> Tuple[SceneParams, list]:
    """Run the optimization loop -> (final params, loss history).

    `steps` is the total step budget: resuming a run checkpointed at step
    k runs steps k..steps-1.  With rebuild_grid_every=k > 0 the grids are
    rebuilt on the host every k steps from the current vertices (not
    after the last step, which no step reads).  checkpoint_dir and
    checkpoint_every save `opt/checkpoint.py` checkpoints (the optimizer's
    state in optax's layout, which the JAX package's fit resumes from);
    resume=True restores the newest complete one first, the params and
    Adam's moments and step count, from the port's checkpoints or the JAX
    package's (npz or orbax), so the steps go on as the uninterrupted run's
    would.  The losses are read back once, at the end.

    With `mesh` every rank runs the loop with the same arguments: the
    steps are data-parallel over its `axis` (`make_train_step`), every
    rebuild is made on every rank from the same parameters, and rank 0
    writes the checkpoints and the log."""
    from ray_tracer_tpu_torch.opt.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint,
    )

    if prep.scene.transmissive is not None:
        raise NotImplementedError(
            "fit() optimizes through the Whitted renderer, which has no "
            "refraction branch — transmissive (dielectric) materials "
            "are served by the path-traced integrator only "
            "(render/pathtrace.py)")
    cfg = prep.cfg

    def stepping(p):
        """The train step over p's grid, and the grid's launch tables."""
        grid, meta = _grid_of(p)
        step, init = make_train_step(meta, cfg, optimizer=optimizer, lr=lr, mesh=mesh,
                                     axis=axis, trainable=trainable)
        return grid, step, init, p.dda, p.frame().consts

    grid, step, init, dda, consts = stepping(prep)
    params, opt_state = init(split_scene(prep.scene))
    start_step = 0
    if resume and checkpoint_dir:
        last = latest_step(checkpoint_dir)
        if last is not None:
            restored, _ = restore_checkpoint(checkpoint_dir, {"params": params,
                                                              "opt_state": opt_state},
                                             step_num=last)
            with torch.no_grad():
                for f, x in zip(SceneParams._fields, params):
                    if x is not None:
                        x.copy_(getattr(restored, f))
            start_step = last
            log.info("resumed from step %s", last)
    if start_step and rebuild_grid_every:
        # the restored verts may lie far from the geometry prepare indexed
        prep = _rebuild(prep, params)
        grid, step, _, dda, consts = stepping(prep)
    losses = []
    for step_no in range(start_step, steps):
        params, opt_state, loss = step(params, opt_state, prep.scene, grid, target, dda=dda,
                                       consts=consts)
        losses.append(loss)
        if log_every and (step_no - start_step) % log_every == 0 and is_host0():
            log.info("step %d loss %.6g", step_no, float(loss))
        if (rebuild_grid_every and (step_no + 1) % rebuild_grid_every == 0
                and step_no + 1 < steps):
            prep = _rebuild(prep, params)
            grid, step, _, dda, consts = stepping(prep)
        if (checkpoint_dir and checkpoint_every and (step_no + 1) % checkpoint_every == 0
                and (mesh is None or is_host0())):
            save_checkpoint(checkpoint_dir, params, opt_state, step_num=step_no + 1)
    return detached(params), [float(x) for x in losses]
