"""`core/vecmath.take`'s backward (`_Take`, `take_grad`, csrc/take_grad.cu).

* On the CPU, take's backward is index_add_ bitwise (its plain version),
  for 1-D and 2-D x, float32 and float64, one row, the fit's pattern (most
  rows in runs of index 0), random indices and a strided index (a column
  of the faces).
* Without autograd (under torch.no_grad(), or x not requiring grad) take is
  the plain index_select: no grad_fn, the same values.
* One train step of the fit's configuration counts `rt.grad.take` 8 times:
  the three vertex gathers of `Scene.triangle_soa`, the renderer's
  `take(tri10, tri)`, and `MaterialTable.gather` of the four trainable
  material fields (base_color, kd, ks, ka); a frame under no_grad counts 0.
* A model of the kernel as it runs on the card (a thread k consecutive rows,
  runs summed in a lane, the lanes' first and last runs joined by the warp's
  segmented scan, `take_grad_kernel`'s flush rules), in float64: the sum of
  its atomics is the float64 sum, and a run costs at most one atomic a
  column for each warp it crosses.
* On the card (marked `card`, skipped without one): the kernel against a
  float64 sum on the same cases.  Its float32 sums are index_add_'s in
  another order, so it is held at the tolerance test_torch_grad.py states
  for atomic order (rtol 1e-4, atol 1e-6 max|sum|).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu_torch.core import vecmath as vm  # noqa: E402
from ray_tracer_tpu_torch.utils import timing  # noqa: E402

WARP = 32


def _case(name: str, device="cpu"):
    """(g (R, C), index (R,), n) of a named case, from a numpy seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    r, c, n, dtype = 3000, 3, 50, np.float32
    if name == "one_row":  # the one-material table: every row to row 0
        r, c, n = 5000, 3, 1
        idx = np.zeros(r, np.int64)
    elif name == "fit_pattern":  # 88% of rows in runs of index 0, hits in short runs
        r, c, n = 6000, 10, 400
        hit = rng.random(r // 6) < 0.12
        runs = np.where(hit, rng.integers(1, n, r // 6), 0)
        idx = np.repeat(runs, rng.integers(1, 12, r // 6))[:r]
        idx = np.concatenate([idx, np.zeros(r - idx.size, np.int64)])
    elif name == "random":  # unsorted, no runs to speak of
        idx = rng.integers(0, n, r)
    elif name.startswith("cols"):
        c = int(name[4:])
        idx = np.sort(rng.integers(0, n, r))
    elif name == "ragged":  # R not a multiple of 32 k, and a short last warp
        r = 32 * 16 * 3 + 77
        idx = np.repeat(np.arange(r // 5 + 1), 5)[:r] % n
    elif name == "float64":
        dtype = np.float64
        idx = np.repeat(rng.integers(0, n, r // 4), 4)
    else:
        raise ValueError(name)
    g = rng.normal(size=(r, c)).astype(dtype)
    return (torch.from_numpy(g).to(device), torch.from_numpy(idx.astype(np.int64)).to(device), n)


CASES = ("one_row", "fit_pattern", "random", "cols1", "cols3", "cols10", "cols7", "ragged",
         "float64")


# ---- the CPU: take's backward is index_add_ -------------------------------

@pytest.mark.parametrize("name", CASES + ("vector", "strided_index"))
def test_take_backward_is_index_add_bitwise(name):
    g, idx, n = _case(name if name in CASES else "cols3")
    if name == "vector":  # a material field such as kd: x is (M,)
        g = g[:, 0].contiguous()
    if name == "strided_index":  # a column of the faces, as triangle_soa takes it
        idx = torch.stack([idx, idx.flip(0)], dim=1)[:, 0]
        assert not idx.is_contiguous()
    x = torch.zeros((n, *g.shape[1:]), dtype=g.dtype, requires_grad=True)
    y = vm.take(x, idx)
    assert type(y.grad_fn).__name__ == "_TakeBackward"
    y.backward(g)
    want = torch.zeros_like(x).index_add_(0, idx, g)
    assert x.grad.dtype == want.dtype and x.grad.shape == want.shape
    assert torch.equal(x.grad.view(-1).view(torch.int8), want.view(-1).view(torch.int8))


@pytest.mark.parametrize("how", ["no_grad", "x_without_grad"])
def test_take_without_autograd_is_index_select(how):
    g, idx, n = _case("fit_pattern")
    x = torch.randn((n, 10), requires_grad=how == "no_grad")
    if how == "no_grad":
        with torch.no_grad():
            y = vm.take(x, idx)
    else:
        y = vm.take(x, idx)
    assert y.grad_fn is None and not y.requires_grad
    assert torch.equal(y, x.index_select(0, idx))


def test_take_grad_cuda_refuses_cpu_tensors():
    g, idx, n = _case("cols3")
    with pytest.raises(ValueError, match="CUDA tensors"):
        vm.take_grad_cuda(g, idx, n)


def test_fit_step_counts_eight_take_backwards():
    """One step of the fit's configuration (turbo serial scene, the fit's
    six trainable fields) at 16x16 on the CPU."""
    from ray_tracer_tpu_torch.config import apply_turbo
    from ray_tracer_tpu_torch.models.scenes import serial_scene_config
    from ray_tracer_tpu_torch.opt import fit
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    cfg = apply_turbo(serial_scene_config(16, 16), "serial")
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, faithful=False))
    prep = prepare(cfg, device="cpu")
    with timing.recording() as rec:
        target = render(prep)
    assert sum(v for (_, k), v in rec.counts.items() if k == "rt.grad.take") == 0
    step, init = fit.make_train_step(
        prep.grid.meta if prep.packed is None else prep.packed.meta, cfg, lr=1e-3,
        trainable=("base_color", "kd", "ks", "ka", "light_pos", "verts"))
    params, opt = init(fit.split_scene(prep.scene))
    grid = prep.grid.arrays if prep.packed is None else prep.packed.arrays
    with timing.recording() as rec:
        step(params, opt, prep.scene, grid, target * 0.9)
    counts = {k: v for (_, k), v in rec.counts.items() if k == "rt.grad.take"}
    assert counts == {"rt.grad.take": 8}


# ---- the kernel's design, modelled in float64 ------------------------------

def _warp_model(g: np.ndarray, idx: np.ndarray, n: int, k: int):
    """take_grad_kernel's atomics, in float64: each warp's 32 lanes own k
    consecutive rows each; a lane flushes each run that begins and ends in
    its rows, keeps its first run (head) and last run (acc); the warp's
    segmented inclusive scan carries each lane's last run right while the
    next lane continues it; a lane flushes its head (with what flows in)
    when it holds two runs or more, and its scanned last run where the next
    lane does not continue it.  Returns (out, atomics a column)."""
    r, c = g.shape
    out = np.zeros((n, c))
    atomics = 0

    def flush(key, val):
        nonlocal atomics
        out[key] += val
        atomics += 1

    for base in range(0, r, WARP * k):
        first, last, single = [-1] * WARP, [-1] * WARP, [True] * WARP
        head, acc = np.zeros((WARP, c)), np.zeros((WARP, c))
        nrows = [max(0, min(k, r - base - lane * k)) for lane in range(WARP)]
        for lane in range(WARP):
            lo = base + lane * k
            if not nrows[lane]:
                continue
            cur, acc[lane] = idx[lo], g[lo]
            first[lane] = cur
            for j in range(lo + 1, lo + nrows[lane]):
                if idx[j] != cur:
                    if single[lane]:
                        head[lane], single[lane] = acc[lane], False
                    else:
                        flush(cur, acc[lane])
                    acc[lane], cur = g[j].astype(np.float64), idx[j]
                else:
                    acc[lane] = acc[lane] + g[j]
            last[lane] = cur
        joins = [lane > 0 and nrows[lane] > 0 and first[lane] == last[lane - 1]
                 for lane in range(WARP)]
        seg = [not (single[lane] and joins[lane]) for lane in range(WARP)]
        v = acc.copy()
        for s in range(5):
            d = 1 << s
            v_prev, seg_prev = v.copy(), list(seg)
            for lane in range(d, WARP):
                if not seg_prev[lane]:
                    v[lane] = v_prev[lane - d] + v_prev[lane]
                seg[lane] = seg_prev[lane] or seg_prev[lane - d]
        for lane in range(WARP):
            if not nrows[lane]:
                continue
            if not single[lane]:
                flush(first[lane], head[lane] + (v[lane - 1] if joins[lane] else 0.0))
            if lane == WARP - 1 or not joins[lane + 1]:
                flush(last[lane], v[lane])
    return out, atomics


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("k", [1, 8, 16])
def test_warp_model_sums_every_row_once(name, k):
    g, idx, n = _case(name)
    g64, ix = g.double().numpy(), idx.numpy()
    out, atomics = _warp_model(g64, ix, n, k)
    want = np.zeros((n, g64.shape[1]))
    np.add.at(want, ix, g64)
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
    runs = 1 + int((ix[1:] != ix[:-1]).sum())
    warps = -(-ix.size // (WARP * k))
    # every run flushed once, plus once more for each warp boundary it crosses
    # and each lane's head it splits (at most two flushes a lane)
    assert atomics <= min(runs + warps - 1, ix.size)
    if name == "one_row":
        assert atomics == warps


# ---- the card --------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_take_grad_kernel_matches_float64_sum(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: take_grad_kernel runs only there")
    g, idx, n = _case(name, device="cuda")
    launches = vm.take_grad_cuda.launches
    got = vm.take_grad(g, idx, n)
    torch.cuda.synchronize()
    assert vm.take_grad_cuda.launches == launches + 1
    want = torch.zeros((n, g.shape[1]), dtype=torch.float64, device="cuda").index_add_(
        0, idx, g.double())
    assert got.dtype == g.dtype and got.shape == (n, g.shape[1])
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-6 * scale)
