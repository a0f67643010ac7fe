"""Row gather + Cramer test per lane: kernel D, its plain version, and
the step-loop timing of `tools/pallas_gather_bench.py`.

    python -m ray_tracer_tpu_torch.tools.gather_bench          # time, on the card
    python -m ray_tracer_tpu_torch.tools.gather_bench check    # kernel D == plain

The JAX tool asks whether a kernel's own row fetch beats the gather engine
for the packed march's per-lane pattern: W lanes each fetch ONE row
idx[i] of an (NB, 9, TL) channel-major table and take the nearest
accepted Cramer t over its TL triangle lanes (`cramer_min`).  Here:

  * `gather_row_test_cuda` launches `csrc/gather_row_test.cu` (kernel D,
    the counterpart of `pallas_gather_test`);
  * `gather_row_test_plain` is `cramer_min` over the gathered rows in plain
    PyTorch, one elementwise op at a time;
  * `gather_row_test` takes the kernel for CUDA tensors and the plain
    version for CPU tensors;
  * `step_loop` is the tool's dependent loop: each step tests the lanes'
    rows and moves each index by 1 + (hit), so the next fetch depends on
    this step's result.  `bench` reports the JAX tool's metric, us per
    step and ns per row, from the difference of a 105-step and a 5-step
    loop (best of 3), at W = 8192, NB = 2270, TL = 128, with inputs from
    numpy.random.default_rng(0) made as the JAX tool makes them.
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import Dict

import numpy as np
import torch

from ray_tracer_tpu_torch.device import resolve_device
from ray_tracer_tpu_torch.kernels import _build

W = 8192  # wave lanes
NB = 2270  # block rows
TL = 128  # triangle lanes per row
CH = 9  # ax ay az bx by bz cx cy cz


def make_inputs(w: int = W, nb: int = NB, tl: int = TL, device=None, seed: int = 0):
    """(blocks (nb, 9, tl), o (w, 3), d (w, 3), idx0 (w,)) as the JAX tool's
    main() draws them from numpy.random.default_rng(seed)."""
    dev = resolve_device(device)
    g = np.random.default_rng(seed)
    blocks = g.uniform(0, 1, (nb, CH, tl)).astype(np.float32)
    o = g.uniform(-2, -1, (w, 3)).astype(np.float32)
    v = g.normal(size=(w, 3))
    d = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    idx0 = g.integers(0, nb, (w,)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (blocks, o, d, idx0))


def _det3(u, v, w):
    """The JAX tool's own expansion (pallas_gather_bench.py:45-48)."""
    return (u[0] * (v[1] * w[2] - v[2] * w[1])
            - v[0] * (u[1] * w[2] - u[2] * w[1])
            + w[0] * (u[1] * v[2] - u[2] * v[1]))


def gather_row_test_plain(blocks, o, d, idx) -> torch.Tensor:
    """cramer_min of each lane's row blocks[idx[i]] -> (W,) f32, +inf where
    no triangle lane is hit."""
    row = blocks[idx.long()]  # (W, 9, TL)
    a, b, c = row[:, 0:3], row[:, 3:6], row[:, 6:9]  # (W, 3, TL)
    e1 = a - b
    e2 = a - c
    s = a - o[:, :, None]
    de = d[:, :, None]
    e1c, e2c, sc, dc = (tuple(x[:, k] for k in range(3)) for x in (e1, e2, s, de))
    A = _det3(e1c, e2c, dc)
    tn = _det3(e1c, e2c, sc)
    bn = _det3(sc, e2c, dc)
    gn = _det3(e1c, sc, dc)
    inv = torch.reciprocal(A)
    t = tn * inv
    beta = bn * inv
    gamma = gn * inv
    ok = (beta > 0) & (gamma > 0) & (beta + gamma < 1) & (t > 0)
    return torch.where(ok, t, torch.full_like(t, float("inf"))).amin(dim=-1)


def gather_row_test_cuda(blocks, o, d, idx) -> torch.Tensor:
    """Kernel D on CUDA tensors; the plain version's output."""
    if not blocks.is_cuda:
        raise ValueError("gather_row_test_cuda takes CUDA tensors")
    if blocks.dtype != torch.float32 or blocks.ndim != 3 or blocks.shape[1] != CH:
        raise ValueError("blocks must be (NB, 9, TL) float32")
    w = idx.shape[0]
    if o.shape != (w, 3) or d.shape != (w, 3) or idx.dtype != torch.int32:
        raise ValueError("o, d must be (W, 3) float32 and idx (W,) int32")
    blocks, o, d, idx = (x.contiguous() for x in (blocks, o, d, idx))
    out = torch.empty((w,), dtype=torch.float32, device=blocks.device)
    lib = _build.library("gather_row_test")
    fn = lib.gather_row_test_launch
    fn.restype = ctypes.c_int
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, p, p]
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = fn(blocks.data_ptr(), o.data_ptr(), d.data_ptr(), idx.data_ptr(), w,
                 blocks.shape[2], out.data_ptr(), stream)
    _build.check(err, "gather_row_test")
    gather_row_test_cuda.launches += 1
    return out


gather_row_test_cuda.launches = 0


def gather_row_test(blocks, o, d, idx) -> torch.Tensor:
    """Kernel D for CUDA tensors, its plain version for CPU tensors."""
    if blocks.is_cuda:
        return gather_row_test_cuda(blocks, o, d, idx)
    if blocks.device.type != "cpu":
        raise ValueError(f"unsupported device {blocks.device}")
    return gather_row_test_plain(blocks, o, d, idx)


def step_loop(n: int, blocks, o, d, idx0, test=gather_row_test) -> torch.Tensor:
    """n dependent steps: test each lane's row, then idx <- (idx + 1 +
    hit) % NB; returns the sum of the hit t per lane."""
    nb = blocks.shape[0]
    acc = torch.zeros((idx0.shape[0],), dtype=torch.float32, device=blocks.device)
    idx = idx0
    for _ in range(n):
        t = test(blocks, o, d, idx)
        fin = torch.isfinite(t)
        idx = torch.remainder(idx + 1 + fin.to(torch.int32), nb)
        acc = acc + torch.where(fin, t, torch.zeros_like(t))
    return acc


def check(w: int = W, nb: int = NB, device=None) -> Dict:
    """Kernel D (on the card) against its plain version on the tool's
    inputs: bitwise.  On the CPU both sides are the plain version."""
    blocks, o, d, idx0 = make_inputs(w, nb, device=device)
    got = gather_row_test(blocks, o, d, idx0)
    want = gather_row_test_plain(blocks, o, d, idx0)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    if bad:
        raise AssertionError(f"kernel D differs from its plain version in {bad} of {w} lanes")
    return {"lanes": w, "rows": nb, "finite": int(fin.sum()), "max_abs_err": err,
            "tolerance": "bitwise", "equal": True, "device": str(blocks.device)}


def _loop_ms(fn, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn(n)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def bench(w: int = W, nb: int = NB, device=None) -> Dict:
    """us per step and ns per row of kernel D's step loop and of the plain
    version's, as the JAX tool reports them: (T(105) - T(5)) / 100, best
    of 3, CUDA events."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the step-loop timing runs on the card only")
    blocks, o, d, idx0 = make_inputs(w, nb, device=dev)
    out = {"lanes": w, "rows": nb, "device": torch.cuda.get_device_name(dev)}
    for name, test in (("kernel", gather_row_test_cuda), ("plain", gather_row_test_plain)):
        def run(n, test=test):
            return step_loop(n, blocks, o, d, idx0, test=test)
        run(5)
        run(105)
        best = float("inf")
        for _ in range(3):
            best = min(best, (_loop_ms(run, 105) - _loop_ms(run, 5)) / 100)
        out[name] = {"us_per_step": best * 1e3, "ns_per_row": best * 1e6 / w}
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--device=cpu" in args else None
    if "check" in args:
        print(json.dumps(check(device=device)))
    else:
        print(json.dumps(bench(device=device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
