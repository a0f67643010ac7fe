"""The collectives the sharded paths use, over a mesh axis.

Counterpart of `ray_tracer_tpu/parallel/collectives.py` on
`torch.distributed`: each function takes the mesh and the axis name
where the JAX one takes the shard_map axis, and runs over that axis's
process group (`DeviceMesh.get_group`).

  * `allreduce_gradients` sums, as `psum` does (not DDP's average);
  * `gather_image` all-gathers equal shards in shard order;
  * `scatter_rays` takes this shard's slice;
  * `min_reduce_hits` keeps the first minimum in shard order, the
    reference's strict-< update when shards hold ascending triangle ids;
  * `ring_shift` sends to shard (i + shift) mod n with
    `batch_isend_irecv` (detached data);
  * `ring_pass` is the ring orbit's hop: a bundle of tensors goes to
    shard i + 1 as one packed tensor, and under autograd the gradients
    of its floating members come back from shard i + 1 as one packed
    tensor (the transpose of the shift, which `ring_shift` alone would
    drop).

A gloo group takes CUDA tensors through host copies, made here
explicitly and only for gloo (two ranks that share one card cannot form
an NCCL group); the compute stays on the device.

JAX's `vma_union` and `pcast_varying` type the carries of shard_map
loops; PyTorch runs each shard eagerly in its own process and has no
such types, so they have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Any, List

import torch
import torch.distributed as dist


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, host: bool) -> torch.Tensor:
    """x as it travels: on the host for gloo, bool as uint8 (not every
    backend reduces or gathers bool)."""
    y = x.detach()
    if y.dtype == torch.bool:
        y = y.to(torch.uint8)
    return (y.cpu() if host else y).contiguous()


def all_gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's x (equal shapes), in rank order of the group."""
    n = dist.get_world_size(group)
    if n == 1:
        return [x]
    host = _via_host(x, group)
    y = _wire(x, host)
    outs = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(outs, y, group=group)
    return [o.to(device=x.device, dtype=x.dtype) for o in outs]


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's x (a new tensor; every rank gets the same
    bits)."""
    if dist.get_world_size(group) == 1:
        return x.detach().clone()
    host = _via_host(x, group)
    y = x.detach().cpu() if host else x.detach().clone()
    y = y.contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank src's x on every rank (a new tensor on x's device)."""
    if dist.get_world_size(group) == 1:
        return x
    host = _via_host(x, group)
    y = _wire(x, host).clone()
    dist.broadcast(y, src=src, group=group)
    return y.to(device=x.device, dtype=x.dtype)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def allreduce_gradients(grads: Any, mesh, axis: str = "rays") -> Any:
    """Sum parameter gradients over the mesh axis (psum).  grads: a
    tensor, or a NamedTuple / tuple / list / dict of tensors and Nones;
    the same structure comes back with each tensor summed.  The tensors of
    one dtype and device travel as one flat buffer, one collective."""
    from ray_tracer_tpu_torch.parallel.multihost import _map

    group = _group(mesh, axis)
    leaves = []
    _map(lambda g: leaves.append(g), grads)
    summed = {}
    by_kind = {}
    for i, g in enumerate(leaves):
        by_kind.setdefault((g.dtype, g.device), []).append(i)
    for idx in by_kind.values():
        flat = all_reduce_sum(torch.cat([leaves[i].reshape(-1) for i in idx]), group)
        lo = 0
        for i in idx:
            k = leaves[i].numel()
            summed[i] = flat[lo:lo + k].reshape(leaves[i].shape)
            lo += k
    it = iter(range(len(leaves)))
    return _map(lambda g: summed[next(it)], grads)


def gather_image(tile_colors: torch.Tensor, mesh, axis: str = "rays") -> torch.Tensor:
    """All-gather per-shard pixel colors into the full flat image:
    (R/D, 3) a shard -> (R, 3) on every rank, in shard order."""
    return torch.cat(all_gather(tile_colors, _group(mesh, axis)))


def scatter_rays(rays_flat, mesh, axis: str = "rays"):
    """This shard's slice of a replicated flat array (or a NamedTuple of
    them, such as a RayBatch): (R, ...) -> (R/D, ...)."""
    d = mesh.size(mesh.mesh_dim_names.index(axis))
    i = mesh.get_local_rank(axis)
    if isinstance(rays_flat, tuple):
        return type(rays_flat)(*(scatter_rays(x, mesh, axis) for x in rays_flat))
    per = rays_flat.shape[0] // d
    return rays_flat[i * per:(i + 1) * per]


def min_reduce_hits(t: torch.Tensor, payload: torch.Tensor, mesh, axis: str = "tris"):
    """Nearest-hit combine across a sharded-geometry axis -> (t_min,
    payload of the winner).  The first minimum wins (torch.argmin's rule,
    in shard order): the reference's strict-< update
    (Serial/geometry.h:164-171) when shards hold ascending id ranges."""
    group = _group(mesh, axis)
    ts = torch.stack(all_gather(t, group))
    ps = torch.stack(all_gather(payload, group))
    s = torch.argmin(ts, dim=0)

    def take(arr):
        idx = s.reshape((1,) + s.shape + (1,) * (arr.ndim - 1 - s.ndim))
        return torch.gather(arr, 0, idx.expand((1,) + arr.shape[1:]))[0]

    return take(ts), take(ps)


def ring_shift(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Neighbour exchange (ppermute): shard i sends x to shard (i + shift)
    mod n and returns what shard (i - shift) mod n sent."""
    group = _group(mesh, axis)
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    i = dist.get_rank(group)
    host = _via_host(x, group)
    y = _wire(x, host)
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(device=x.device, dtype=x.dtype)


def _words(x: torch.Tensor) -> torch.Tensor:
    """x (R, ...) as int32 words (R, k): floats by their bits, bools and
    integers by value (int32 holds every id and flag the ring carries)."""
    x = x.detach().reshape(x.shape[0], -1)
    if x.dtype in (torch.float32, torch.float64):
        return x.contiguous().view(torch.int32)
    return x.to(torch.int32)


def _unwords(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype in (torch.float32, torch.float64):
        x = w.contiguous().view(like.dtype)
    elif like.dtype == torch.bool:
        x = w != 0
    else:
        x = w.to(like.dtype)
    return x.reshape(like.shape)


def _word_count(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:]) * (2 if x.dtype == torch.float64 else 1)


class _RingPass(torch.autograd.Function):
    """Forward: the bundle (side tensors, then the differentiable ones) to
    shard i + 1 as one int32 tensor.  Backward: the incoming gradients of
    the differentiable members, packed into one tensor, to shard i - 1."""

    @staticmethod
    def forward(ctx, mesh, axis, n_side, *xs):
        ctx.mesh, ctx.axis, ctx.n_side = mesh, axis, n_side
        packed = torch.cat([_words(x) for x in xs], dim=1)
        out = ring_shift(packed, mesh, axis, 1)
        outs, lo = [], 0
        for x in xs:
            k = _word_count(x)
            outs.append(_unwords(out[:, lo:lo + k], x))
            lo += k
        ctx.mark_non_differentiable(*outs[:n_side])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        gs = grads[ctx.n_side:]
        flat = torch.cat([g.reshape(g.shape[0], -1) for g in gs], dim=1)
        back = ring_shift(flat, ctx.mesh, ctx.axis, -1)
        out, lo = [], 0
        for g in gs:
            k = math.prod(g.shape[1:])
            out.append(back[:, lo:lo + k].reshape(g.shape))
            lo += k
        return (None, None, None) + (None,) * ctx.n_side + tuple(out)


def ring_pass(side, diff, mesh, axis: str):
    """One hop of a ring orbit -> (side', diff'): every tensor of `side`
    (detached data: rays, ids, flags, t's) and of `diff` (floating
    tensors that may carry gradients) as shard (i - 1) mod n sent them.
    The bundle travels as one packed tensor, one collective a hop; under
    autograd the gradients of `diff` travel back the same way, so the
    backward of an orbit is one chain of shifts that every rank issues in
    the same order.  Every tensor has the hop's rays on its first axis."""
    side, diff = list(side), list(diff)
    outs = _RingPass.apply(mesh, axis, len(side), *side, *diff)
    return list(outs[:len(side)]), list(outs[len(side):])


__all__ = [
    "all_gather", "all_reduce_sum", "allreduce_gradients", "broadcast", "gather_image",
    "min_reduce_hits", "ring_pass", "ring_shift", "scatter_rays",
]
