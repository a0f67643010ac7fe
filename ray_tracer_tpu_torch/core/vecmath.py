"""Batched 3-vector math on tensors of shape (..., 3).

Counterpart of `ray_tracer_tpu/core/vecmath.py`.  Every op is written as
separate single elementwise tensor ops (multiply, add, subtract, divide,
sqrt), in the JAX package's order: `dot` and `length2` add the three
products left to right, `cross` is explicit multiply-and-subtract, `det3`
expands as t1 - t2 + t3, `normalize` is 1/sqrt with the n2 > 0 guard.
No composite op (linalg.cross, sum over the 3-axis, addcmul, lerp,
einsum) and no rsqrt appears on this path: the composites' CUDA builds
contract a*b+c into FMAs, rsqrt is not correctly rounded, and the
byte-exact image depends on every rounding step standing alone.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ray_tracer_tpu_torch.kernels import _build
from ray_tracer_tpu_torch.utils.timing import count


def take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x's rows at a 1-D index (x[index]) as an index_select.  Under
    autograd (x requiring grad, grad enabled) it is `_Take`, the same
    index_select whose backward is `take_grad`: on the card a kernel that
    sums each run of equal consecutive indices before its atomics (every
    missed lane gathers row 0, every lane of a one-material scene the
    material table's row 0), on the CPU index_add_.  Otherwise it is the
    plain index_select."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Take.apply(x, index)
    return x.index_select(0, index)


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        count("rt.grad.take")
        return take_grad(g.contiguous(), index.contiguous(), ctx.rows), None


def take_grad(g: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """The (n, *g.shape[1:]) sum of g's rows at `index` (take's backward):
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if g.is_cuda:
        return take_grad_cuda(g, index, n)
    if g.device.type != "cpu":
        raise ValueError(f"unsupported device {g.device}")
    return take_grad_plain(g, index, n)


def take_grad_plain(g: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """take_grad's plain version: zeros with index_add_."""
    return torch.zeros((n, *g.shape[1:]), dtype=g.dtype, device=g.device).index_add_(0, index, g)


def take_grad_cuda(g: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """take_grad on the card (`csrc/take_grad.cu`): zeros, then one launch
    that adds each run of equal consecutive indices once a column.  g
    contiguous float32 or float64 with index's rows; index (R,) int64 on
    g's device, each in [0, n) (as the forward's index_select checked
    it)."""
    if not g.is_cuda:
        raise ValueError("take_grad_cuda takes CUDA tensors")
    if g.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"g must be float32 or float64, not {g.dtype}")
    if index.dtype != torch.int64 or index.ndim != 1:
        raise ValueError("index must be a 1-D int64 tensor")
    if g.ndim < 1 or g.shape[0] != index.shape[0]:
        raise ValueError(f"g's rows {tuple(g.shape)[:1]} are not index's {tuple(index.shape)}")
    if index.device != g.device:
        raise ValueError("g and index must be on one device")
    if not (g.is_contiguous() and index.is_contiguous()):
        raise ValueError("g and index must be contiguous")
    if n < 0:
        raise ValueError(f"n must be >= 0, not {n}")
    out = torch.zeros((n, *g.shape[1:]), dtype=g.dtype, device=g.device)
    fn = _build.launcher("take_grad", "take_grad_launch", _TAKE_GRAD_ARGTYPES)
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), index.data_ptr(), g.shape[0], math.prod(g.shape[1:]),
                 g.element_size(), out.data_ptr(),
                 torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "take_grad")
    take_grad_cuda.launches += 1
    return out


take_grad_cuda.launches = 0
_TAKE_GRAD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true IEEE division.  PyTorch's CUDA `x / python_scalar`
    multiplies by the scalar's reciprocal instead, which can differ by
    one ulp; a 0-d tensor on x's own device keeps the division (made by
    a fill, not copied from the host, so no synchronisation)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis: (...,3),(...,3)->(...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product (reference: Serial/geometry.h:36-42)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length2(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]


def _with_grad(forward, backward, doc: str):
    """y = forward(x), made differentiable by the rule backward(g, y) when
    x requires grad (an autograd Function); otherwise forward itself."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = forward(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, g):
            (y,) = ctx.saved_tensors
            return backward(g, y)

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return Fn.apply(x)
        return forward(x)

    fn.__doc__ = doc
    return fn


def _numpy_sqrt(x: torch.Tensor) -> torch.Tensor:
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))


# numpy's root of a CPU tensor, with the JAX package's sqrt rule g * (0.5 / ans)
_cpu_sqrt = _with_grad(_numpy_sqrt, lambda g, y: g * (0.5 / y), "")


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's CPU sqrt (float32 and
    float64) is a vectorized approximation that misses the IEEE root by
    one ulp on just under 1% of inputs; numpy's is IEEE, as CUDA's is.
    Differentiable on both devices."""
    return _cpu_sqrt(x) if x.device.type == "cpu" else torch.sqrt(x)


def _f32(c: float) -> float:
    return float(np.float32(c))


# XLA's f32 tanh on the CPU (its EmitFastTanh with FMA, after Eigen's): a
# clamp, an odd rational polynomial in x^2 by Horner, x itself near 0.
_TANH_CLAMP = _f32(7.99881172180175781)
_TANH_NUM = tuple(_f32(c) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
_TANH_DEN = tuple(_f32(c) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))
_TANH_SMALL = _f32(0.0004)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """a*b + c for f32 tensors with one rounding, as a fused multiply-add:
    the f64 product of two f32 values is exact, the f64 sum is rounded
    to f32."""
    return (a.double() * b.double() + c).float()


def _tanh_xla(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x2, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        num = _fma_f32(x2, num, c)
    num = xc * num
    den = torch.full_like(x2, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        den = _fma_f32(x2, den, c)
    return torch.where(torch.abs(x) < _TANH_SMALL, x, num / den)


tanh = _with_grad(_tanh_xla, lambda g, y: (g + g * y) * (1.0 - y), """\
f32 tanh with the bits of XLA's on the CPU, the same on the card (single
elementwise ops, each FMA written as an f64 multiply-add rounded to f32);
torch.tanh and the float64 tanh rounded differ from jnp.tanh on many
inputs.  The backward is JAX's rule, (g + g*ans) * (1 - ans).""")

sigmoid = _with_grad(lambda x: 1.0 / (1.0 + torch.exp(-x)),
                     lambda g, y: g * (y * (1.0 - y)), """\
1 / (1 + exp(-x)), jax.nn.sigmoid's formula and order, with torch's exp
(XLA's f32 exp is its own approximation: the last bits differ from JAX's
on some inputs, tests/test_torch_soft_visibility.py counts them).  The
backward is JAX's rule, g * (ans * (1 - ans)).""")


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt(length2(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize: zero vectors stay zero (Vec3::normalize's
    `if (nor2 > 0)` guard, Serial/geometry.h:23-30)."""
    n2 = length2(a)
    pos = n2 > 0
    one = torch.ones_like(n2)
    inv = torch.where(pos, one / sqrt(torch.where(pos, n2, one)),
                      torch.zeros_like(n2))
    return a * inv[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection I - 2(I.N)N (reference: Parallel/raytracer.cu:875-878)."""
    return incident - normal * (2.0 * dot(incident, normal))[..., None]


def det3(a1, a2, a3, b1, b2, b3, c1, c2, c3):
    """3x3 determinant with the reference's expansion order t1 - t2 + t3
    (Serial/raytracer.cpp:203-211)."""
    t1 = a1 * (b2 * c3 - b3 * c2)
    t2 = a2 * (b1 * c3 - b3 * c1)
    t3 = a3 * (b1 * c2 - b2 * c1)
    return t1 - t2 + t3
