"""The port's multihost and scaling helpers (parallel/multihost.py,
parallel/scaling.py) on process groups of 1, 2 and 4 CPU ranks
(tests/torch_ranks.py; tests/test_multihost_scaling.py:10 and
tests/test_multiprocess.py for the JAX package).

* Single-process mode: initialize() without arguments forms a one-rank
  group (idempotently); rank 0 is host 0, its tile is every ray, the scene
  broadcast returns its argument, the global mesh has one device, and the
  sharded Whitted wave is render()'s image.
* 2- and 4-rank groups: only rank 0 is host 0 and writes the PPM, whose
  bytes are the single-device render's; gather_image_host0 gives rank 0
  the image and the others None; the tiles cover the rays in order; the
  broadcast hands every rank rank 0's tensors and passes other leaves.
* scaling_report over [1] and [1, 2]: rows with efficiency 1 at the base,
  and the note that shared devices are no hardware evidence.
* balance_report's numbers equal the JAX function's (run op by op, whose
  traversal step counts the port's equal) on the csr and packed grids.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.parallel import scaling as jax_scaling  # noqa: E402
from ray_tracer_tpu.render.renderer import prepare as jax_prepare  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8  # noqa: E402
from ray_tracer_tpu_torch.parallel.scaling import balance_report  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import render  # noqa: E402
from torch_ranks import case_prep, run_ranks  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {w: run_ranks("multihost_helpers", w, tmp_path_factory.mktemp(f"m{w}"))
            for w in WORLDS}


def test_single_process_helpers(tmp_path):
    res = run_ranks("single_process", 1, tmp_path)[0]
    assert res["world"] == 1 and res["backend"] == "gloo" and res["is_host0"]
    assert res["bounds"] == (0, 1000)
    assert res["broadcast_is_arg"] and res["mesh_size"] == 1
    np.testing.assert_array_equal(res["image"], render(case_prep("whitted_wave")).numpy())
    rows = res["scaling"]["rows"]
    assert [r["devices"] for r in rows] == [1] and rows[0]["efficiency"] == 1.0
    assert rows[0]["mrays_per_s"] > 0 and "note" in res["scaling"]


@pytest.mark.parametrize("world", WORLDS)
def test_host0_writes_the_image(groups, world):
    want = render(case_prep("csr")).numpy()
    res = groups[world]
    assert [r["is_host0"] for r in res] == [True] + [False] * (world - 1)
    assert [r["wrote"] for r in res] == [True] + [False] * (world - 1)
    assert all(r["count"] == world and r["mesh_size"] == world for r in res)
    np.testing.assert_array_equal(read_ppm(res[0]["ppm"]), tonemap_u8(want))
    np.testing.assert_array_equal(res[0]["gathered"], want)
    assert all(r["gathered"] is None for r in res[1:])
    for r in res:
        np.testing.assert_array_equal(r["image"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_tile_bounds_and_broadcast(groups, world):
    res = groups[world]
    bounds = [r["bounds"] for r in res]
    assert bounds[0][0] == 0 and bounds[-1][1] == 1000
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    chunk = -(-1000 // world)
    assert all(hi - lo == min(chunk, 1000 - lo) for lo, hi in bounds)
    for r in res:
        b = r["broadcast"]
        np.testing.assert_array_equal(b["a"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(b["b"], np.zeros(2, np.int64))
        assert b["c"] == "kept" and b["d"] is None


def test_scaling_report_rows(groups):
    rep = groups[2][0]["scaling"]
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    assert rep["rows"][0]["efficiency"] == 1.0
    assert all(r["mrays_per_s"] > 0 for r in rep["rows"])
    assert rep["rays_per_frame"] == 16 * 16 * 2 and "not hardware" in rep["note"]
    assert "rows" in groups[2][1]["scaling"]  # every rank gets its own rows


@pytest.mark.parametrize("traversal", ["csr", "packed"])
def test_balance_report_equals_jax(tiny_prep, traversal):
    prep = case_prep("csr" if traversal == "csr" else "packed_persistent")
    jprep = tiny_prep
    if traversal == "packed":
        cfg = dataclasses.replace(jprep.cfg, render=dataclasses.replace(
            jprep.cfg.render, faithful=False, det_dtype="float32", traversal="packed",
            scheduler="persistent", wave=64, fused_shadow=True))
        jprep = jax_prepare(cfg, scene=jprep.scene)
    for n in (4, 8):
        got = balance_report(prep, n)
        with jax.disable_jit():
            want = jax_scaling.balance_report(jprep, n)
        assert got == want, (n, got, want)
        assert got["balance_round_robin"] >= got["balance_contiguous"] - 0.05
