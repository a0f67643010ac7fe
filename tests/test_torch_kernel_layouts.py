"""The layouts and reductions of kernels B and C that can be checked on the
CPU: kernel B's tables derived from the CSR grid (occupancy bits, the
(start, count) pairs, the vertices in CSR order); a numpy model of kernel
C's shuffle fold (each step's rows dealt over the warp) against the
sequential row loop it replaces; and the rule that the card's launch does
not read the JAX wave width.  The kernels themselves run on the card only
(chip_smoke.py)."""

import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu_torch.accel.grid import build_grid  # noqa: E402
from ray_tracer_tpu_torch.config import apply_turbo  # noqa: E402
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.ops import persistent as ps  # noqa: E402
from ray_tracer_tpu_torch.ops import traverse_packed as tp  # noqa: E402
from ray_tracer_tpu_torch.ops.camera import camera_rays  # noqa: E402
from ray_tracer_tpu_torch.ops.traverse import (  # noqa: E402
    dda_tables, traverse_grid_cuda, vertex_table)
from ray_tracer_tpu_torch.render.renderer import prepare  # noqa: E402


def _arrays(name):
    if name == "gradcheck":
        return scenes.concat_mesh_arrays(scenes.gradcheck_mesh_parts())[:2]
    return scenes.scene_numpy_arrays(getattr(scenes, f"{name}_scene_config")(8, 8))[:2]


def _tri9(verts, faces):
    v = torch.from_numpy(np.asarray(verts, np.float32))
    f = torch.from_numpy(np.asarray(faces, np.int64))
    return vertex_table(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ["serial", "parallel", "gradcheck"])
def test_dda_tables_are_the_csr_grid(name, exact):
    """The occupancy bits are diff(cell_start) > 0, the int2 table holds
    (cell_start, count) of every cell, and the cell-ordered vertex table
    is tri9[tri_ids] byte for byte."""
    verts, faces = _arrays(name)
    grid = build_grid(verts, faces, exact_overlap=exact, device="cpu")
    tri9 = _tri9(verts, faces)
    tabs = dda_tables(grid.arrays, tri9)
    cs = grid.host.cell_start
    counts = np.diff(cs)
    n_cells = counts.shape[0]
    words = tabs.occupancy.numpy().view(np.uint32)
    assert tabs.occupancy.dtype == torch.int32
    assert words.shape[0] * 32 >= n_cells > (words.shape[0] - 1) * 32
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(-1)
    np.testing.assert_array_equal(bits[:n_cells].astype(bool), counts > 0)
    assert not bits[n_cells:].any()
    assert 0 < (counts > 0).sum() < n_cells  # both kinds of cell occur
    rng = tabs.cell_range.numpy()
    assert tabs.cell_range.dtype == torch.int32 and rng.shape == (n_cells, 2)
    np.testing.assert_array_equal(rng[:, 0], cs[:-1])
    np.testing.assert_array_equal(rng[:, 1], counts)
    want = tri9.numpy()[grid.host.tri_ids]
    got = tabs.cell_tri9.numpy()
    assert got.dtype == np.float32 and got.shape == (grid.meta.nnz, 9)
    assert got.tobytes() == want.tobytes()


def test_prepare_derives_the_tables_for_csr_only():
    cfg = scenes.serial_scene_config(8, 8)
    prep = prepare(cfg, device="cpu")
    want = dda_tables(prep.grid.arrays, vertex_table(*prep.scene.triangle_soa()))
    for got, w in zip(prep.dda, want):
        assert torch.equal(got, w)
    assert prepare(apply_turbo(cfg, "serial"), device="cpu").dda is None


NO_SLOT = 1 << 30
LANES = np.arange(32)


def _sequential_row_min(t, accept):
    """The former one-thread loop of csrc/packed_march.cu: the first slot
    of the row minimum of the accepted t; slot 0 when none is below +inf."""
    n, bt = t.shape
    m = np.full((n,), np.inf, t.dtype)
    slot = np.zeros((n,), np.int32)
    for j in range(bt):
        take = accept[:, j] & (t[:, j] < m)
        m = np.where(take, t[:, j], m)
        slot = np.where(take, j, slot)
    return m, slot


def _rows(rng, n, bt):
    """Rows with ties (values drawn from a few levels), +inf lanes and
    rejected lanes, including rows with nothing accepted."""
    levels = np.array([0.5, 1.0, 1.0, 2.0, np.inf], np.float32)
    t = levels[rng.integers(0, levels.size, size=(n, bt))]
    t = np.where(rng.random((n, bt)) < 0.3, (rng.random((n, bt)) * 4).astype(np.float32), t)
    accept = rng.random((n, bt)) < 0.6
    accept[: n // 8] = False  # nothing accepted
    t[n // 8: n // 4] = np.inf  # only +inf accepted
    return t.astype(np.float32), accept


def _lex_min(t, k, ot, ok, where=True):
    """(t, k) <- (ot, ok) where ot < t, or ot == t and ok < k."""
    take = where & ((ot < t) | ((ot == t) & (ok < k)))
    return np.where(take, ot, t), np.where(take, ok, k)


def _shfl_down(x, off):
    """__shfl_down_sync over 32 lanes: lanes past the end keep their own."""
    src = np.where(LANES + off < 32, LANES + off, LANES)
    return x[src]


def _segmented_fold(t, k, key):
    """Kernel C's segmented butterfly: after it, the first lane of each
    run of equal `key` holds the run's lexicographic (t, k) minimum."""
    for off in (1, 2, 4, 8, 16):
        t, k = _lex_min(t, k, _shfl_down(t, off), _shfl_down(k, off),
                        _shfl_down(key, off) == key)
    return t, k


def warp_rows_min_model(testers, t, accept):
    """csrc/packed_march.cu rows_min_warp: the rows of the lanes in the
    32-bit `testers` mask (tester i's row in t[i], accept[i], in lane
    order) are dealt 32 slots a round; lane q takes pair base + q, whose
    row has rank (base + q) // bt and owner the rank-th set bit
    (__fns); after the segmented fold each owner reads its first lane of
    the round.  Returns (m, slot) per lane."""
    bt = t.shape[1]
    bits = np.array([(testers >> i) & 1 for i in range(32)], bool)
    owners = np.flatnonzero(bits)
    pairs = owners.size * bt
    first = np.cumsum(bits) - bits  # popc(testers & lanemask_lt)
    first = first * bt
    m = np.full(32, np.inf, t.dtype)
    slot = np.full(32, NO_SLOT, np.int64)
    for base in range(0, pairs, 32):
        q = base + LANES
        rank = q // bt
        live = q < pairs
        j = np.where(live, q - rank * bt, 0)
        r = np.minimum(rank, owners.size - 1)
        ok = live & accept[r, j] & (t[r, j] < np.inf)
        tv = np.where(ok, t[r, j], np.inf).astype(t.dtype)
        sv = np.where(ok, j, NO_SLOT)
        tv, sv = _segmented_fold(tv, sv, rank)
        head = np.where(first > base, first - base, 0) & 31
        mine = bits & (first < base + 32) & (first + bt > base)
        m, slot = _lex_min(m, slot, tv[head], sv[head], mine)
    return m, np.where(m < np.inf, slot, 0)


@pytest.mark.parametrize("block_tris", [1, 14, 28, 56])
@pytest.mark.parametrize("n_testers", [1, 3, 17, 32])
def test_warp_row_fold_is_the_sequential_row_loop(n_testers, block_tris):
    """Kernel C's warp form: each testing lane gets exactly the sequential
    loop's (row min, first slot) of its own row, however the rows'
    slots fall into rounds of 32."""
    rng = np.random.default_rng(n_testers * 100 + block_tris)
    for trial in range(20):
        lanes = np.sort(rng.choice(32, size=n_testers, replace=False))
        testers = int(sum(1 << int(i) for i in lanes))
        t, accept = _rows(rng, n_testers, block_tris)
        if trial % 4 == 0:
            t[:] = t[0]  # every row alike: ties across rows too
        m_want, slot_want = _sequential_row_min(t, accept)
        m, slot = warp_rows_min_model(testers, t, accept)
        assert m[lanes].tobytes() == m_want.tobytes()
        np.testing.assert_array_equal(slot[lanes], slot_want)


@pytest.fixture(scope="module")
def turbo16():
    cfg = apply_turbo(scenes.serial_scene_config(16, 16), "serial")
    prep = prepare(cfg, device="cpu")
    return cfg, prep, camera_rays(cfg.camera, device="cpu")


@pytest.mark.parametrize("wave", [1, 7, 12288])
def test_persistent_trace_on_the_cpu_ignores_wave(turbo16, wave):
    cfg, prep, rays = turbo16
    kw = dict(fuse_shadow=True, t_gate=0.0, shadow_gate=0.1, shadow_mint=0.1,
              serial_quirk=True, shadow_skip_dead=True, shade_serial=True, need_t=True,
              need_steps=True, need_shadow_tri=True, compact=True)
    light = prep.scene.light_pos
    base = ps.persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
                               wave=65536, **kw)
    got = ps.persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
                              wave=wave, **kw)
    assert bool(base.hit.any())
    for g, w in zip(got, base):
        assert torch.equal(g, w)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that
    persistent_trace takes its card path to the (recorded) kernel call."""

    @property
    def is_cuda(self):
        return True


def test_persistent_launch_does_not_take_the_wave_width(turbo16, monkeypatch):
    """On the card, persistent_trace hands kernel C the same call whatever
    the JAX wave width (march_cuda has no width to take), and that call
    gives the CPU path's records."""
    cfg, prep, rays = turbo16
    calls = []

    def kernel_c(r, grid, meta, light, **kw):
        calls.append(kw)
        plain_kw = {k: v for k, v in kw.items()
                    if k not in ("queue", "n_work", "iters_out", "consts")}
        return tp.march_plain(RayBatch(*(x.as_subclass(torch.Tensor) for x in r)),
                              grid, meta, light, **plain_kw)

    assert "wave" not in inspect.signature(tp.march_cuda).parameters
    kw = dict(fuse_shadow=True, t_gate=0.0, shadow_gate=0.1, shadow_mint=0.1,
              serial_quirk=True, shadow_skip_dead=True, shade_serial=True, need_t=True,
              need_steps=True, need_shadow_tri=True)
    args = (prep.packed.arrays, prep.packed.meta, prep.scene.light_pos)
    want = ps.persistent_trace(rays, *args, **kw)
    assert bool(want.hit.any())
    monkeypatch.setattr(ps, "march_cuda", kernel_c)
    on_card = RayBatch(*(x.as_subclass(_OnCard) for x in rays))
    for wave in (1, 7, 12288, 65536):
        got = ps.persistent_trace(on_card, *args, wave=wave, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.as_subclass(torch.Tensor), w)
    assert len(calls) == 4 and all(c == calls[0] for c in calls)
    assert not any("wave" in k for k in calls[0])


def test_traverse_grid_cuda_refuses_cpu_tensors():
    """Kernel B's wrapper takes CUDA tensors only; it never falls back to
    the plain version, and counts no launch."""
    cfg = scenes.serial_scene_config(8, 8)
    prep = prepare(cfg, device="cpu")
    rays = camera_rays(cfg.camera, device="cpu")
    before = traverse_grid_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        traverse_grid_cuda(rays, prep.grid.arrays, prep.grid.meta,
                           vertex_table(*prep.scene.triangle_soa()), tables=prep.dda)
    assert traverse_grid_cuda.launches == before
