"""All-pairs nearest ray/triangle hit: kernel A and its plain version.

Counterpart of `ray_tracer_tpu/ops/pallas_intersect.py`, whose Pallas TPU
kernel (`_kernel`, launched by `_run`, wrapped by `intersect_brute_pallas`)
sweeps every (ray, triangle) pair and keeps the nearest accepted hit,
lowest index first on ties.  Its arithmetic is the Cramer solve with the
reciprocal of the determinant MULTIPLIED into the three numerators
(pallas_intersect.py:65-83), not `cramer_tbg`'s division.

  * `brute_intersect_cuda` launches the hand-written kernel
    `csrc/brute_intersect.cu` on CUDA tensors.
  * `brute_intersect_plain` is the same function in plain PyTorch, one
    elementwise op at a time, swept over triangle chunks.
  * `brute_intersect` takes the kernel for CUDA tensors and the plain
    version for CPU tensors, and nothing else.
  * `intersect_brute_kernel` is the ray-batch wrapper the renderer calls
    for traversal="brute_pallas".
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tracer_tpu_torch.core.rays import RayBatch
from ray_tracer_tpu_torch.kernels import _build
from ray_tracer_tpu_torch.ops.intersect import (
    BruteResult,
    _det_a,
    _det_beta,
    _det_gamma,
    _det_t,
    barycentric_pass,
)


# (ray, triangle) pairs the plain sweep evaluates at once
PAIRS_PER_CHUNK_CPU = 1 << 22
PAIRS_PER_CHUNK_CUDA = 1 << 24


def _check_inputs(orig, dirn, tri9):
    if orig.dtype != torch.float32 or dirn.dtype != torch.float32 or tri9.dtype != torch.float32:
        raise TypeError("brute_intersect takes float32 rays and triangles")
    if orig.ndim != 2 or orig.shape[1] != 3 or dirn.shape != orig.shape:
        raise ValueError("orig and dirn must both be (R, 3)")
    if tri9.ndim != 2 or tri9.shape[0] != 9:
        raise ValueError("tri9 must be (9, F)")
    if not (orig.device == dirn.device == tri9.device):
        raise ValueError("all inputs must be on one device")


def brute_intersect_plain(orig: torch.Tensor, dirn: torch.Tensor,
                          tri9: torch.Tensor, t_lower: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (t (R,) f32, +inf where no hit; tri_id (R,) i32, -1 where no hit).
    orig/dirn (R,3) f32, tri9 (9,F) f32 rows v0x v0y v0z v1x .. v2z."""
    _check_inputs(orig, dirn, tri9)
    r, f = orig.shape[0], tri9.shape[1]
    dev = orig.device
    best_t = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    best_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
    budget = PAIRS_PER_CHUNK_CUDA if orig.is_cuda else PAIRS_PER_CHUNK_CPU
    chunk = max(1, budget // max(r, 1))
    o, d = orig[:, None, :], dirn[:, None, :]
    for lo in range(0, f, chunk):
        hi = min(f, lo + chunk)
        a = tri9[0:3, lo:hi].T[None]  # (1, C, 3)
        e1 = a - tri9[3:6, lo:hi].T[None]  # v0 - v1
        e2 = a - tri9[6:9, lo:hi].T[None]  # v0 - v2
        s = a - o  # (R, C, 3)
        inv_a = torch.reciprocal(_det_a(e1, e2, d))
        t = _det_t(e1, e2, s) * inv_a
        beta = _det_beta(e2, s, d) * inv_a
        gamma = _det_gamma(e1, s, d) * inv_a
        accept = barycentric_pass(beta, gamma) & (t > t_lower)
        tm = torch.where(accept, t, torch.full_like(t, float("inf")))
        j = torch.argmin(tm, dim=1)  # first index of the chunk minimum
        m = torch.gather(tm, 1, j[:, None])[:, 0]
        upd = m < best_t
        best_t = torch.where(upd, m, best_t)
        best_id = torch.where(upd, j + lo, best_id)
    return best_t, best_id.to(torch.int32)


def brute_intersect_cuda(orig: torch.Tensor, dirn: torch.Tensor,
                         tri9: torch.Tensor, t_lower: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A on CUDA tensors; the same outputs as the plain version."""
    _check_inputs(orig, dirn, tri9)
    if not orig.is_cuda:
        raise ValueError("brute_intersect_cuda takes CUDA tensors")
    orig, dirn, tri9 = orig.contiguous(), dirn.contiguous(), tri9.contiguous()
    r, f = orig.shape[0], tri9.shape[1]
    t = torch.empty((r,), dtype=torch.float32, device=orig.device)
    tri_id = torch.empty((r,), dtype=torch.int32, device=orig.device)
    if r == 0:
        return t, tri_id
    lib = _build.library("brute_intersect")
    fn = lib.brute_intersect_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float] + [ctypes.c_void_p] * 3
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        err = fn(orig.data_ptr(), dirn.data_ptr(), tri9.data_ptr(), r, f,
                 float(t_lower), t.data_ptr(), tri_id.data_ptr(), stream)
    _build.check(err, "brute_intersect")
    brute_intersect_cuda.launches += 1
    return t, tri_id


brute_intersect_cuda.launches = 0


def brute_intersect(orig, dirn, tri9, t_lower: float):
    """Kernel A for CUDA tensors, its plain version for CPU tensors."""
    if orig.is_cuda:
        return brute_intersect_cuda(orig, dirn, tri9, t_lower)
    if orig.device.type != "cpu":
        raise ValueError(f"unsupported device {orig.device}")
    return brute_intersect_plain(orig, dirn, tri9, t_lower)


def triangle_table(v0, v1, v2) -> torch.Tensor:
    """(9, F) f32 SoA table of the three vertex arrays (F,3)."""
    return torch.cat([v0, v1, v2], dim=1).to(torch.float32).T.contiguous()


def intersect_brute_kernel(rays: RayBatch, v0, v1, v2, t_lower: float = 0.0,
                           tri9: torch.Tensor = None) -> BruteResult:
    """All-pairs nearest hit (f32, production semantics: t > t_lower).
    Returns the BruteResult of `intersect_brute_pallas`: any_pass = hit =
    a finite t with a valid triangle id; tri_id -1 where there is none.
    `tri9` may carry a prebuilt `triangle_table(v0, v1, v2)`."""
    if tri9 is None:
        tri9 = triangle_table(v0, v1, v2)
    t, tid = brute_intersect(rays.orig.to(torch.float32),
                             rays.dirn.to(torch.float32), tri9, float(t_lower))
    hit = torch.isfinite(t) & (tid >= 0) & (tid < tri9.shape[1])
    return BruteResult(any_pass=hit, t=t,
                       tri_id=torch.where(hit, tid, torch.full_like(tid, -1)),
                       hit=hit)
