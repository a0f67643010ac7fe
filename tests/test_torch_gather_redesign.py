"""Kernel D's design held on the CPU (ray_tracer_tpu_torch/csrc/
gather_row_test.cu, ray_tracer_tpu_torch/tools/gather_bench.py).

A plain-torch model of the kernel as it runs on the card: one warp a lane,
thread j testing triangle lanes j, j+32, ... of the lane's row in order
with the kernel's running `ok && t < best`, then the warp's shuffle-down
fold (offsets 16, 8, 4, 2, 1; a lane past the warp's end keeps its own
value).  It is held bitwise to `gather_row_test_plain` and, through it, to
the JAX tool's `cramer_min` run op by op (tools/pallas_gather_bench.py), on
shuffled indices, every lane on one row, rows no lane takes, degenerate
triangles (A = 0: NaN and inf in t, beta and gamma) and lanes with no hit.
The wrapper refuses CPU tensors and inputs the kernel does not take, and
binds its ctypes launcher once.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu_torch.tools import gather_bench as gb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, NB = 512, 64
WARP = 32


@pytest.fixture(scope="module")
def jax_tool():
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "pallas_gather_bench", os.path.join(REPO, "tools", "pallas_gather_bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


def _jax_min(tool, blocks, o, d, idx):
    with jax.disable_jit():
        rows = jnp.asarray(blocks.numpy())[jnp.asarray(idx.numpy())]
        return np.asarray(jax.vmap(tool.cramer_min)(jnp.asarray(o.numpy()),
                                                    jnp.asarray(d.numpy()), rows), np.float32)


def _lane_terms(blocks, o, d, idx):
    """(t, beta, gamma, A) of every (lane, triangle lane), the kernel's
    arithmetic in the plain version's op order."""
    row = blocks[idx.long()]
    a, b, c = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    e1, e2, s = a - b, a - c, a - o[:, :, None]
    de = d[:, :, None]
    e1c, e2c, sc, dc = (tuple(x[:, k] for k in range(3)) for x in (e1, e2, s, de))
    A = gb._det3(e1c, e2c, dc)
    inv = torch.reciprocal(A)
    return gb._det3(e1c, e2c, sc) * inv, gb._det3(sc, e2c, dc) * inv, \
        gb._det3(e1c, sc, dc) * inv, A


def warp_model(blocks, o, d, idx):
    """Kernel D's warp a lane: each thread's running minimum over its
    strided triangle lanes, then the shuffle-down fold."""
    t, beta, gamma, _ = _lane_terms(blocks, o, d, idx)
    ok = (beta > 0) & (gamma > 0) & (beta + gamma < 1) & (t > 0)
    w, tl = t.shape
    best = torch.full((w, WARP), float("inf"))
    for j in range(WARP):
        for col in range(j, tl, WARP):  # thread j's lanes, in its order
            take = ok[:, col] & (t[:, col] < best[:, j])
            best[:, j] = torch.where(take, t[:, col], best[:, j])
    for off in (16, 8, 4, 2, 1):
        src = torch.arange(WARP) + off
        other = torch.where(src < WARP, best[:, src.clamp(max=WARP - 1)], best)
        best = torch.where(other < best, other, best)
    return best[:, 0]


def _same(got, want):
    return np.array_equal(np.asarray(got).view(np.uint32), np.asarray(want).view(np.uint32))


def _cases():
    blocks, o, d, idx = gb.make_inputs(W, NB, device="cpu", seed=3)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(W))
    ab, ao, ad, aidx = gb.aimed_inputs(W, NB, device="cpu", seed=4)
    even = (aidx // 2) * 2  # the odd rows are taken by no lane
    return {
        "shuffled": (ab, ao[perm], ad[perm], aidx[perm]),
        "tool_shuffled": (blocks, o, d, idx[perm]),
        "one_row": (ab, ao, ad, torch.full_like(aidx, 5)),
        "rows_no_lane_takes": (ab, ao, ad, even),
        "degenerate": gb.degenerate_inputs(W, NB, device="cpu", seed=5),
        "no_hit": (ab, ao, (-ad).contiguous(), aidx),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_warp_model_is_the_plain_version_and_the_jax_tool(case, jax_tool):
    blocks, o, d, idx = _cases()[case]
    model = warp_model(blocks, o, d, idx)
    plain = gb.gather_row_test_plain(blocks, o, d, idx)
    assert _same(model.numpy(), plain.numpy())
    assert _same(model.numpy(), _jax_min(jax_tool, blocks, o, d, idx))
    fin = torch.isfinite(plain)
    if case == "no_hit":
        assert not bool(fin.any())
    elif case in ("shuffled", "degenerate", "rows_no_lane_takes"):
        assert float(fin.float().mean()) > 0.5
    if case == "one_row":
        assert torch.unique(idx).numel() == 1
    if case == "rows_no_lane_takes":
        assert not bool((idx % 2).any())


def test_degenerate_triangles_make_nan_and_inf():
    """The degenerate table has A = 0 triangle lanes, whose t, beta and
    gamma are NaN or inf, and every lane's answer is still the plain
    version's (the model runs through them)."""
    blocks, o, d, idx = gb.degenerate_inputs(W, NB, device="cpu", seed=5)
    t, beta, gamma, A = _lane_terms(blocks, o, d, idx)
    assert bool((A == 0).any())
    for x in (t, beta, gamma):
        assert bool(torch.isnan(x).any()) and bool(torch.isinf(x).any())
    assert _same(warp_model(blocks, o, d, idx).numpy(),
                 gb.gather_row_test_plain(blocks, o, d, idx).numpy())


def test_input_cases_at_the_tools_shapes():
    """The four sets phase D holds the card to, at a reduced W: their
    shapes, one row for every lane of one_row, NaN-free rays."""
    cases = gb.input_cases(W, NB, device="cpu")
    assert set(cases) == {"tool", "aimed", "one_row", "degenerate"}
    for name, (blocks, o, d, idx) in cases.items():
        assert blocks.shape == (NB, gb.CH, gb.TL) and o.shape == d.shape == (W, 3)
        assert idx.dtype == torch.int32 and int(idx.min()) >= 0 and int(idx.max()) < NB
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(d).all()), name
    assert torch.unique(cases["one_row"][3]).numel() == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    blocks, o, d, idx = gb.aimed_inputs(8, 4, device="cpu")
    before = gb.gather_row_test_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        gb.gather_row_test_cuda(blocks, o, d, idx)
    bad = [(blocks.double(), o, d, idx), (blocks[:, :8], o, d, idx),
           (blocks, o[:4], d, idx), (blocks, o, d.double(), idx), (blocks, o, d, idx.long())]
    for args in bad:
        with pytest.raises(ValueError, match="must be"):
            gb.gather_row_test_cuda(*args)
    assert gb.gather_row_test_cuda.launches == before


def test_launcher_is_bound_once(monkeypatch):
    calls = []

    class Fn:
        restype = argtypes = None

    class Lib:
        gather_row_test_launch = Fn()

    def library(name):
        calls.append(name)
        return Lib()

    monkeypatch.setattr(gb._build, "_LAUNCHERS", {})
    monkeypatch.setattr(gb._build, "library", library)
    bind = lambda: gb._build.launcher("gather_row_test", "gather_row_test_launch",  # noqa: E731
                                      gb._ARGTYPES)
    first = bind()
    assert bind() is first and bind() is first
    assert calls == ["gather_row_test"]
    assert len(first.argtypes) == 8
