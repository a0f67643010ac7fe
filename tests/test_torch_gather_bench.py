"""Kernel D's plain version (ray_tracer_tpu_torch/tools/gather_bench.py)
against the JAX tool's `cramer_min` (tools/pallas_gather_bench.py) on the
gathered rows, run op by op: bitwise.

`tools/` is no package, so the JAX tool is loaded from its path; its
import sets JAX_COMPILATION_CACHE_DIR with os.environ.setdefault, so the
environment is restored afterwards.
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


def _aimed(w=256, nb=64, seed=1):
    """Rays aimed at one triangle lane of their row, so most lanes hit."""
    blocks, o, _, idx = gb.make_inputs(w, nb, device="cpu", seed=seed)
    lane = torch.from_numpy(np.random.default_rng(seed).integers(0, gb.TL, w))
    row = blocks[idx.long(), :, lane]  # (W, 9)
    centroid = (row[:, 0:3] + row[:, 3:6] + row[:, 6:9]) / 3
    d = centroid - o
    d = d / d.norm(dim=1, keepdim=True)
    return blocks, o, d.contiguous(), idx


def test_plain_matches_jax_tool_on_its_inputs(jax_tool):
    """The tool's own random inputs (make_inputs draws them as main()
    does), at a reduced W."""
    blocks, o, d, idx = gb.make_inputs(2048, 400, device="cpu")
    want = _jax_min(jax_tool, blocks, o, d, idx)
    got = gb.gather_row_test(blocks, o, d, idx).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isfinite(want).sum() > 0


def test_plain_matches_jax_tool_on_aimed_rays(jax_tool):
    blocks, o, d, idx = _aimed()
    want = _jax_min(jax_tool, blocks, o, d, idx)
    got = gb.gather_row_test_plain(blocks, o, d, idx).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isfinite(want).mean() > 0.5


def test_inputs_match_the_jax_tool(jax_tool):
    """make_inputs at the tool's shapes draws what the tool's main() draws."""
    blocks, o, d, idx = gb.make_inputs(device="cpu")
    assert blocks.shape == (jax_tool.NB, jax_tool.CH, jax_tool.TL)
    assert o.shape == d.shape == (jax_tool.W, 3) and idx.shape == (jax_tool.W,)
    g = np.random.default_rng(0)
    np.testing.assert_array_equal(
        blocks.numpy(), g.uniform(0, 1, (jax_tool.NB, jax_tool.CH, jax_tool.TL)).astype(np.float32))


def test_step_loop_and_check_on_cpu():
    blocks, o, d, idx = _aimed(64, 16)
    acc = gb.step_loop(3, blocks, o, d, idx)
    assert acc.shape == (64,) and bool(torch.isfinite(acc).all()) and bool((acc > 0).any())
    out = gb.check(128, 32, device="cpu")
    assert out["equal"] and out["max_abs_err"] == 0.0


def test_cuda_wrapper_refuses_cpu_tensors():
    blocks, o, d, idx = _aimed(8, 4)
    before = gb.gather_row_test_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        gb.gather_row_test_cuda(blocks, o, d, idx)
    with pytest.raises(RuntimeError, match="card"):
        gb.bench(8, 4, device="cpu")
    assert gb.gather_row_test_cuda.launches == before
