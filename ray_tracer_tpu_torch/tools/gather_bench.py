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
  * `check` holds the kernel to the plain version bitwise on each of
    `input_cases`: the tool's inputs, aimed rays, every lane on one row,
    and degenerate triangles;
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


def aimed_inputs(w: int = W, nb: int = NB, device=None, seed: int = 1):
    """make_inputs with each ray aimed at the centroid of one triangle lane
    of its row, so that most lanes hit (the CPU tests' aimed rays)."""
    blocks, o, _, idx = make_inputs(w, nb, device="cpu", seed=seed)
    lane = torch.from_numpy(np.random.default_rng(seed).integers(0, TL, w))
    row = blocks[idx.long(), :, lane]  # (W, 9)
    centroid = (row[:, 0:3] + row[:, 3:6] + row[:, 6:9]) / 3
    d = centroid - o
    d = d / d.norm(dim=1, keepdim=True)
    dev = resolve_device(device)
    return tuple(x.contiguous().to(dev) for x in (blocks, o, d, idx))


def degenerate_inputs(w: int = W, nb: int = NB, device=None, seed: int = 2):
    """aimed_inputs with degenerate triangles: in every row, b = a on every
    4th triangle lane, c = a on every 4th from 1, all three vertices equal on
    every 4th from 2 (A = 0 and tn = 0: t NaN), a vertex at +inf on every
    16th from 3, and on every 8th from 7 a = 0 and b = the ray direction of
    the row's first lane, whose ray then lies in that triangle's plane (A = 0
    exactly with tn and bn nonzero: t and beta infinite, gamma NaN)."""
    blocks, o, d, idx = aimed_inputs(w, nb, device="cpu", seed=seed)
    blocks = blocks.clone()
    blocks[:, 3:6, 0::4] = blocks[:, 0:3, 0::4]
    blocks[:, 6:9, 1::4] = blocks[:, 0:3, 1::4]
    blocks[:, 3:6, 2::4] = blocks[:, 0:3, 2::4]
    blocks[:, 6:9, 2::4] = blocks[:, 0:3, 2::4]
    blocks[:, 6, 3::16] = float("inf")
    first = torch.full((nb,), w, dtype=torch.int64).scatter_reduce(
        0, idx.long(), torch.arange(w), "amin")
    in_plane = torch.tensor([1.0, 0.0, 0.0]).repeat(nb, 1)  # rows no lane takes
    taken = first < w
    in_plane[taken] = d[first[taken]]
    blocks[:, 0:3, 7::8] = 0.0
    blocks[:, 3:6, 7::8] = in_plane[:, :, None]
    dev = resolve_device(device)
    return tuple(x.to(dev) for x in (blocks, o, d, idx))


def input_cases(w: int = W, nb: int = NB, device=None) -> Dict[str, tuple]:
    """The inputs kernel D is held to its plain version on: the tool's own,
    aimed rays, every lane on one row, and degenerate triangles."""
    blocks, o, d, idx = make_inputs(w, nb, device=device)
    return {"tool": (blocks, o, d, idx),
            "aimed": aimed_inputs(w, nb, device=device),
            "one_row": (blocks, o, d, torch.full_like(idx, min(7, nb - 1))),
            "degenerate": degenerate_inputs(w, nb, device=device)}


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


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def gather_row_test_cuda(blocks, o, d, idx) -> torch.Tensor:
    """Kernel D on CUDA tensors; the plain version's output.  The launch
    enters the tensors' device only when it is not the current one."""
    if blocks.dtype != torch.float32 or blocks.ndim != 3 or blocks.shape[1] != CH:
        raise ValueError("blocks must be (NB, 9, TL) float32")
    w = idx.shape[0]
    if (o.shape != (w, 3) or d.shape != (w, 3) or idx.dtype != torch.int32
            or o.dtype != torch.float32 or d.dtype != torch.float32):
        raise ValueError("o, d must be (W, 3) float32 and idx (W,) int32")
    if not blocks.is_cuda:
        raise ValueError("gather_row_test_cuda takes CUDA tensors")
    dev = blocks.device
    if o.device != dev or d.device != dev or idx.device != dev:
        raise ValueError("blocks, o, d and idx must be on one device")
    blocks, o, d, idx = (x.contiguous() for x in (blocks, o, d, idx))
    out = torch.empty((w,), dtype=torch.float32, device=dev)
    args = (blocks.data_ptr(), o.data_ptr(), d.data_ptr(), idx.data_ptr(), w,
            blocks.shape[2], out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    fn = _build.launcher("gather_row_test", "gather_row_test_launch", _ARGTYPES)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
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
    """Kernel D (on the card) against its plain version on each of
    `input_cases`: bitwise.  On the CPU both sides are the plain version."""
    out = {"lanes": w, "rows": nb, "tolerance": "bitwise", "cases": {}}
    err = 0.0
    for name, (blocks, o, d, idx) in input_cases(w, nb, device=device).items():
        got = gather_row_test(blocks, o, d, idx)
        want = gather_row_test_plain(blocks, o, d, idx)
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if bad:
            raise AssertionError(f"kernel D differs from its plain version in {bad} of {w} "
                                 f"lanes on the {name} inputs")
        fin = torch.isfinite(want)
        if bool(fin.any()):
            err = max(err, float((got[fin] - want[fin]).abs().max()))
        out["cases"][name] = {"finite": int(fin.sum()),
                              "distinct_rows": int(torch.unique(idx).numel())}
        out["device"] = str(blocks.device)
    return dict(out, max_abs_err=err, equal=True,
                finite=out["cases"]["tool"]["finite"])


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
