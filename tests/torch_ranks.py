"""Groups of torch.distributed ranks on the CPU for the port's multi-device
tests, and the work those ranks do.

`run_ranks("fn", world, tmp_path)` starts `world` processes of this file,
each one rank of a gloo group joined through a file:// rendezvous in
tmp_path (no port, so that parallel test workers cannot collide), runs
`fn(rank, world)` from this module and pickles what it returns.  A rank
that fails, or a group that outlives `timeout` seconds, fails the test;
every collective is bounded by the group's own timeout as well.

The configurations (`case_prep`, `case_names`) are shared by the ranks
and by the tests, which render the same configurations on one device.
Nothing here imports JAX.

    python tests/torch_ranks.py FN RANK WORLD INIT OUT THREADS   # one rank
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GROUP_TIMEOUT = 180.0  # seconds: the join and every collective
OUT_DIR = None  # a rank's output directory (the test's tmp_path)


def run_ranks(fn: str, world: int, tmp_path, timeout: float = 420.0, threads: int = 1) -> list:
    """The return values of fn(rank, world) on each of `world` gloo ranks,
    in rank order.  A failure names the rank that failed first (the others
    are then stopped), the world, the seconds since the start and the tail
    of that rank's log; a group past `timeout` names every rank still
    running with its log's tail.  threads: each rank's torch threads (0:
    torch's default; the teardown's stress driver varies it)."""
    tmp = str(tmp_path)
    init = f"file://{tmp}/rendezvous"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    outs = [os.path.join(tmp, f"rank{i}.pkl") for i in range(world)]
    logs = [os.path.join(tmp, f"rank{i}.log") for i in range(world)]
    procs = []
    t0 = time.monotonic()
    for i in range(world):
        with open(logs[i], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), fn, str(i), str(world), init,
                 outs[i], str(threads)], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))

    def tail(i: int) -> str:
        with open(logs[i]) as fh:
            return fh.read()[-4000:]

    first = None  # (rank, returncode, seconds) of the first rank that failed
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() - t0 > timeout:
                running = [i for i, p in enumerate(procs) if p.poll() is None]
                raise AssertionError(
                    f"{fn} on {world} ranks did not finish in {timeout} s; ranks {running} "
                    "still running:\n" + "\n".join(f"--- rank {i}:\n{tail(i)}" for i in running))
            failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                first = (failed[0], procs[failed[0]].returncode, time.monotonic() - t0)
                break  # the others would wait on it
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if first is None:
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            first = (bad[0], procs[bad[0]].returncode, time.monotonic() - t0)
    if first is not None:
        i, rc, secs = first
        raise AssertionError(f"rank {i} of {fn} on {world} ranks failed (exit code {rc}, "
                             f"{secs:.1f} s after the start):\n{tail(i)}")
    results = []
    for out in outs:
        with open(out, "rb") as fh:
            results.append(pickle.load(fh))
    return results


def run_groups(fn: str, worlds, tmp_of, timeout: float = 420.0) -> dict:
    """run_ranks of fn on a group of each world size, the groups at once
    (tmp_of(world): each group's directory) -> {world: results}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(worlds)) as pool:
        futures = {w: pool.submit(run_ranks, fn, w, tmp_of(w), timeout) for w in worlds}
        return {w: f.result() for w, f in futures.items()}


@contextlib.contextmanager
def one_rank_group():
    """A one-rank gloo group in this process (initialize() without
    arguments), yielding a CPU mesh over it; the group is left
    (multihost.shutdown) on the way out, so that the test process holds
    none afterwards."""
    import torch.distributed as dist

    from ray_tracer_tpu_torch.parallel import multihost
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    multihost.initialize(backend="gloo", timeout=GROUP_TIMEOUT)
    try:
        yield make_mesh(devices="cpu")
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# The configurations (the JAX tests' sharded cases, on the port)
# ---------------------------------------------------------------------------

E = 100.0  # the furnace's constant environment
GI_LIGHT = 40.0


def _rep(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


def _gradcheck(size=16, **kw):
    from ray_tracer_tpu_torch.models.scenes import gradcheck_scene

    scene, cfg = gradcheck_scene(size, size, device="cpu")
    return scene, _rep(cfg, ray_tile=64, **kw)


PACKED = dict(faithful=False, det_dtype="float32", traversal="packed", scheduler="persistent",
              wave=64)


def _furnace(size=16):
    """The mirror furnace (tests/test_pathtrace.py:_mirror_prep, km = 1)
    under a constant environment E, its background set apart from E."""
    from ray_tracer_tpu_torch.config import CameraConfig, LightConfig, MaterialConfig, SceneConfig
    from ray_tracer_tpu_torch.models import meshes
    from ray_tracer_tpu_torch.models.scenes import scene_from_meshes

    mats = (MaterialConfig(base_color=(127.5,) * 3, km=1.0, reflective=True),)
    light = LightConfig(position=(0.0, 5.0, 0.0), intensity=0.0)
    scene = scene_from_meshes([(meshes.make_plane(extent=8.0, y=-1.0, density=2), 0)], mats,
                              light, device="cpu")
    scene = scene._replace(env_image=torch.full((4, 8, 3), E))
    cfg = SceneConfig(materials=mats, light=light, camera=CameraConfig(
        position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=size, height=size))
    return scene, _rep(cfg, gi_samples=2, gi_depth=1, gi_wave="on", background=(7.0, 5.0, 3.0),
                       ray_tile=64, **PACKED)


def _env_bands():
    env = np.zeros((8, 16, 3), np.float32)
    env[:4] = (200.0, 0.0, 0.0)
    env[4:] = (0.0, 0.0, 200.0)
    return torch.from_numpy(env)


def case_prep(name: str):
    """The prepared configuration `name` on the CPU."""
    from ray_tracer_tpu_torch.config import LightConfig, apply_turbo
    from ray_tracer_tpu_torch.models.scenes import parallel_scene_config
    from ray_tracer_tpu_torch.render.renderer import prepare

    if name == "csr":  # tests/test_sharding.py:35
        scene, cfg = _gradcheck()
    elif name == "csr_spp2":
        scene, cfg = _gradcheck(spp=2)
    elif name == "packed_persistent":  # tests/test_sharding.py:427
        scene, cfg = _gradcheck(fused_shadow=True, **PACKED)
    elif name == "whitted_wave":  # tests/test_whitted_wave.py:170
        return prepare(apply_turbo(parallel_scene_config(16, 16), "parallel"), device="cpu")
    elif name in ("gi_segments", "gi_wave"):  # tests/test_pathtrace.py:156
        scene, cfg = _gradcheck(12, gi_samples=2, gi_depth=2,
                                gi_wave="off" if name == "gi_segments" else "on", **PACKED)
        scene = scene._replace(light_intensity=torch.tensor(GI_LIGHT))
    elif name == "gi_wave_mirror_env":  # tests/test_pathtrace.py:955
        scene, cfg = _furnace()
    elif name == "env":  # tests/test_env.py:148
        scene, cfg = _gradcheck(faithful=False)
        scene = scene._replace(env_image=_env_bands())
    elif name == "extra_lights":  # tests/test_lights.py:96
        scene, cfg = _gradcheck()
        cfg = dataclasses.replace(cfg, extra_lights=(LightConfig((-4.0, 6.0, -2.0), 1.0),))
    elif name == "gi_dielectric":  # tests/test_dielectric.py:328
        scene, cfg = _gradcheck(12, gi_samples=2, gi_depth=2, **PACKED)
        m = scene.materials.base_color.shape[0]
        trans = torch.zeros((m,), dtype=torch.bool)
        trans[-1] = True
        scene = scene._replace(transmissive=trans, ior=torch.full((m,), 1.5))
    else:
        raise KeyError(name)
    return prepare(cfg, scene=scene)


def case_names():
    return ["csr", "csr_spp2", "packed_persistent", "whitted_wave", "gi_segments", "gi_wave",
            "gi_wave_mirror_env", "env", "extra_lights", "gi_dielectric"]


# ---------------------------------------------------------------------------
# The ranks' work
# ---------------------------------------------------------------------------


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def sharded_renders(rank: int, world: int) -> dict:
    """render_sharded of every case at both dealings, the AOV buffers and
    AO with mesh=, and on 4 ranks intersect_brute_sharded over a 2 x 2
    ("rays", "tris") mesh (rank 0's results; the others return None)."""
    from ray_tracer_tpu_torch.core.rays import RayBatch
    from ray_tracer_tpu_torch.ops.camera import camera_rays
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from ray_tracer_tpu_torch.parallel.shard import intersect_brute_sharded, render_sharded
    from ray_tracer_tpu_torch.render.aov import render_ao, render_aovs

    mesh = make_mesh(devices="cpu")
    out = {"images": {}}
    for name in case_names():
        prep = case_prep(name)
        out["images"][name] = {balance: _numpy(render_sharded(prep, mesh=mesh, balance=balance))
                               for balance in (False, True)}
    mesh2 = make_mesh(world, ("rays", "tris"), shape=(world, 1), devices="cpu")
    for name in ("csr", "packed_persistent"):
        prep = case_prep(name)
        out[f"aovs_{name}"] = {k: _numpy(v) for k, v in render_aovs(prep, mesh=mesh2).items()}
        out[f"ao_{name}"] = _numpy(render_ao(prep, samples=6, radius=1.0, mesh=mesh2))
    if world == 4:
        prep = case_prep("csr")
        rays = camera_rays(prep.cfg.camera, device="cpu")
        v0, v1, v2 = prep.scene.triangle_soa()
        grid2 = make_mesh(4, ("rays", "tris"), shape=(2, 2), devices="cpu")
        res = intersect_brute_sharded(RayBatch(*rays), v0, v1, v2, grid2, t_lower=1e-4)
        out["brute"] = {k: _numpy(v) for k, v in res._asdict().items()}
    return out if rank == 0 else None


def gloo_threads(since=()) -> dict:
    """{thread id: name} of this process's threads that gloo named
    (pt_gloo_runloop, gloo_tcp_loop, ...), other than the ids in `since`
    (Linux: /proc/self/task)."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as fh:
                name = fh.read().strip()
        except OSError:  # the thread ended while listed
            continue
        if "gloo" in name and tid not in since:
            out[tid] = name
    return out


def teardown(rank: int, world: int) -> dict:
    """A 1-D mesh and a 2-D ("rays", "tris") mesh (whose "rays" axis of 1
    makes a sub-group a rank), a sum over each, then multihost.shutdown()
    inside the work: the sums, the sub-groups the meshes made, the gloo
    threads running before it, and whether a group or a gloo thread is left
    after it."""
    import torch.distributed as dist

    from ray_tracer_tpu_torch.parallel import collectives as coll
    from ray_tracer_tpu_torch.parallel import multihost
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices="cpu")
    mesh2 = make_mesh(world, ("rays", "tris"), shape=(1, world), devices="cpu")
    one = torch.ones((1,))
    sums = [float(coll.allreduce_gradients({"g": one * (rank + 1)}, m, axis)["g"])
            for m, axis in ((mesh, "rays"), (mesh2, "tris"), (mesh2, "rays"))]
    subgroups = len({g.group_name for m in (mesh, mesh2) for g in m.get_all_groups()}
                    - {dist.group.WORLD.group_name})
    del mesh, mesh2  # a mesh held here would hold its groups past the shutdown
    before = gloo_threads()
    multihost.shutdown()
    return {"sums": sums, "subgroups": subgroups, "threads_before": before,
            "initialized_after": dist.is_initialized(), "threads_after": gloo_threads()}


# run_ranks names the rank whose exit it sees first, and a rank that leaves
# its group makes its peers' next collective fail at once: the peers below
# linger before they fail or leave, so that the first to fail is rank 1.
LINGER = 10.0  # seconds


def fail_on_rank1(rank: int, world: int) -> dict:
    """Rank 1 raises inside the work; the others return."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(LINGER)
    return {"rank": rank}


def fail_in_allreduce(rank: int, world: int) -> dict:
    """Rank 1 raises while the others wait in an all_reduce it never joins
    (they learn of it when rank 1 leaves the group)."""
    import torch.distributed as dist

    if rank == 1:
        time.sleep(1.0)  # the others are in the all_reduce by now
        raise RuntimeError("rank 1 fails on purpose")
    try:
        dist.all_reduce(torch.ones((1,)))
    except RuntimeError:
        time.sleep(LINGER)
        raise
    return {"rank": rank}


def collectives(rank: int, world: int) -> dict:
    """Every collective of parallel/collectives.py on known data; each rank
    returns what it got."""
    from ray_tracer_tpu_torch.parallel import collectives as coll
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices="cpu")
    x = torch.arange(world * 4 * 3, dtype=torch.float32).reshape(world * 4, 3)
    mine = coll.scatter_rays(x, mesh, "rays")
    full = coll.gather_image(mine, mesh, "rays")
    ring = coll.ring_shift(torch.tensor([[float(rank)]]), mesh, "rays", shift=1)
    ring_back = coll.ring_shift(torch.tensor([[float(rank)]]), mesh, "rays", shift=-1)
    grads = coll.allreduce_gradients(
        {"g": torch.ones((2,)).sum(), "none": None, "v": torch.full((3,), float(rank))},
        mesh, "rays")
    rng = np.random.default_rng(7)
    ts = rng.integers(0, 4, size=(world, 64)).astype(np.float32)  # ties on purpose
    ts[ts == 3] = np.inf
    t_min, who = coll.min_reduce_hits(torch.from_numpy(ts[rank]),
                                      torch.full((64,), rank, dtype=torch.int32), mesh, "rays")
    b = coll.broadcast(torch.full((2,), float(rank) + 1.0))
    return {"mine": _numpy(mine), "full": _numpy(full), "ring": _numpy(ring),
            "ring_back": _numpy(ring_back), "g": _numpy(grads["g"]), "v": _numpy(grads["v"]),
            "none": grads["none"], "ts": ts, "t_min": _numpy(t_min), "who": _numpy(who),
            "broadcast": _numpy(b)}


FIT_CASES = ("csr", "env_padding", "spp2", "spp2_padding")


def fit_case(name: str):
    """(prepared, target, trainable) of a sharded-fit case: the gradcheck
    scene at 16x16 (tests/test_sharding.py:59), at 15x13 with an
    environment map so that padding lanes see it (tests/test_opt.py:229),
    and at spp 2, whole and padded (tests/test_opt.py:277, :310)."""
    from ray_tracer_tpu_torch.render.renderer import prepare

    if name == "csr":
        scene, cfg = _gradcheck()
    elif name == "env_padding":
        from ray_tracer_tpu_torch.models.scenes import gradcheck_scene

        scene, cfg = gradcheck_scene(15, 13, device="cpu")
        cfg = _rep(cfg, ray_tile=64, faithful=False)
        scene = scene._replace(env_image=_env_bands())
    elif name == "spp2":
        scene, cfg = _gradcheck(spp=2)
    elif name == "spp2_padding":
        from ray_tracer_tpu_torch.models.scenes import gradcheck_scene

        scene, cfg = gradcheck_scene(15, 13, device="cpu")
        cfg = _rep(cfg, ray_tile=64, spp=2)
    else:
        raise KeyError(name)
    prep = prepare(cfg, scene=scene)
    rng = np.random.default_rng(3)
    h, w = cfg.camera.height, cfg.camera.width
    target = torch.from_numpy(rng.uniform(0.0, 80.0, size=(h, w, 3)).astype(np.float32))
    trainable = ("base_color", "kd", "light_pos", "verts")
    if name == "env_padding":
        trainable += ("env_image",)
    return prep, target, trainable


def sharded_steps(rank: int, world: int) -> dict:
    """Two sharded Adam steps of every fit case against the unsharded step
    from the same parameters (loss, gradients), the parameters of every
    rank after each step, and a sharded fit() with a grid rebuild."""
    from ray_tracer_tpu_torch.opt import fit
    from ray_tracer_tpu_torch.parallel.collectives import all_gather
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices="cpu")
    out = {}
    for name in FIT_CASES:
        prep, target, trainable = fit_case(name)
        grid, meta = prep.grid.arrays, prep.grid.meta
        s_step, s_init = fit.make_train_step(meta, prep.cfg, lr=1e-3, mesh=mesh,
                                             trainable=trainable)
        u_step, u_init = fit.make_train_step(meta, prep.cfg, lr=1e-3, trainable=trainable)
        params, opt = s_init(fit.split_scene(prep.scene))
        steps = []
        for _ in range(2):
            up, uo = u_init(fit.detached(params))
            _, _, u_loss = u_step(up, uo, prep.scene, grid, target, dda=prep.dda)
            params, opt, s_loss = s_step(params, opt, prep.scene, grid, target, dda=prep.dda)
            steps.append({
                "loss": float(s_loss), "unsharded_loss": float(u_loss),
                "grads": {f: _numpy(getattr(params, f).grad) for f in trainable},
                "unsharded_grads": {f: _numpy(getattr(up, f).grad) for f in trainable},
                "same_on_every_rank": {
                    f: all(torch.equal(x.view(torch.int32),
                                       getattr(params, f).detach().view(torch.int32))
                           for x in all_gather(getattr(params, f).detach()))
                    for f in trainable}})
        out[name] = steps
    # a perfect self-target under an environment map, on rays that do not
    # divide the shards: the padding lanes (env lookups) are masked out
    from ray_tracer_tpu_torch.models.scenes import gradcheck_scene
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    scene, cfg = gradcheck_scene(5, 5, device="cpu")
    scene = scene._replace(env_image=torch.full((4, 8, 3), 90.0))
    prep = prepare(_rep(cfg, ray_tile=32, faithful=False), scene=scene)
    step, init = fit.make_train_step(prep.grid.meta, prep.cfg, mesh=mesh)
    params, opt = init(fit.split_scene(prep.scene))
    out["env_selftarget_loss"] = float(step(params, opt, prep.scene, prep.grid.arrays,
                                            render(prep), dda=prep.dda)[2])
    prep, target, _ = fit_case("csr")
    _, losses = fit.fit(prep, target, steps=3, lr=1e-3, mesh=mesh, trainable=("kd", "verts"),
                        rebuild_grid_every=1, log_every=0)
    _, single = fit.fit(prep, target, steps=3, lr=1e-3, trainable=("kd", "verts"),
                        rebuild_grid_every=1, log_every=0)
    out["fit_loop"] = {"sharded": losses, "single": single}
    return out if rank == 0 else {k: [s["same_on_every_rank"] for s in out[k]]
                                  for k in FIT_CASES}


def multihost_helpers(rank: int, world: int) -> dict:
    """The multihost helpers on this group: rank and count, host-0 image
    assembly and PPM, tile bounds, the scene broadcast, the global mesh,
    and on 2 ranks scaling_report over [1, 2]."""
    from ray_tracer_tpu_torch.parallel import multihost
    from ray_tracer_tpu_torch.parallel.mesh import axis_size
    from ray_tracer_tpu_torch.parallel.scaling import scaling_report
    from ray_tracer_tpu_torch.parallel.shard import render_sharded

    multihost.initialize()  # idempotent: the group is formed
    prep = case_prep("csr")
    mesh = multihost.global_mesh(("rays",), devices="cpu")
    img = render_sharded(prep, mesh=mesh)
    path = os.path.join(OUT_DIR, "multihost.ppm")
    wrote = multihost.write_ppm_host0(path, img)
    scene = {"a": torch.full((3,), float(rank)), "b": np.full((2,), rank, np.int64),
             "c": "kept", "d": None}
    got = multihost.broadcast_scene_host0(scene)
    out = {"is_host0": multihost.is_host0(), "count": multihost.process_count(),
           "bounds": multihost.host_tile_bounds(1000), "wrote": wrote, "ppm": path,
           "gathered": multihost.gather_image_host0(img), "image": _numpy(img),
           "broadcast": {k: _numpy(v) for k, v in got.items()},
           "mesh_size": axis_size(mesh, "rays")}
    if world == 2:
        out["scaling"] = scaling_report(prep, device_counts=[1, 2], repeats=1)
    return out


def single_process(rank: int, world: int) -> dict:
    """Single-process mode: initialize() with no arguments forms a one-rank
    group on a local store (twice: it is idempotent), and every helper
    works there."""
    import torch.distributed as dist

    from ray_tracer_tpu_torch.parallel import multihost
    from ray_tracer_tpu_torch.parallel.mesh import axis_size, make_mesh
    from ray_tracer_tpu_torch.parallel.scaling import scaling_report
    from ray_tracer_tpu_torch.parallel.shard import render_sharded

    multihost.initialize()
    multihost.initialize()
    prep = case_prep("whitted_wave")
    scene = {"a": np.ones(3)}
    return {"world": dist.get_world_size(), "backend": dist.get_backend(),
            "is_host0": multihost.is_host0(), "bounds": multihost.host_tile_bounds(1000),
            "broadcast_is_arg": multihost.broadcast_scene_host0(scene) is scene,
            "mesh_size": axis_size(make_mesh(devices="cpu"), "rays"),
            "image": _numpy(render_sharded(prep, mesh=make_mesh(devices="cpu"))),
            "scaling": scaling_report(prep, device_counts=[1], repeats=1)}


# ---------------------------------------------------------------------------
# Geometry sharded by ring orbits (tests/test_torch_ring.py)
# ---------------------------------------------------------------------------

_RING_PACKED = dict(traversal="packed", det_dtype="float32", fused_shadow=False)
# name -> (render overrides, scene changes): the JAX ring tests' cases
# (tests/test_sharding.py:166-291, :451, :547, :575, :626, :655, :701) on
# the gradcheck scene at 16x16; the test builds the same scenes for JAX
RING_CASES = {
    "brute": (dict(traversal="brute"), {}),
    "packed": (_RING_PACKED, {}),
    "brute_bounces": (dict(traversal="brute", max_bounces=2), {"reflective": True}),
    "packed_bounces": (dict(_RING_PACKED, max_bounces=2), {"reflective": True}),
    "brute_spp2_smooth_env": (dict(traversal="brute", spp=2, normal_mode="smooth"),
                              {"env": True}),
    "packed_texture_lights": (dict(_RING_PACKED, texture="checker", texture_scale=4.0,
                                   max_bounces=1, shadow_samples=4, light_radius=0.3),
                              {"reflective": True, "extra_light": True, "env": True}),
    "packed_soft": (dict(_RING_PACKED, soft_visibility=0.05, soft_primary=0.05), {}),
    "gi_packed": (dict(_RING_PACKED, scheduler="persistent", gi_samples=2, gi_depth=1),
                  {"env": True}),
    "gi_brute_smooth": (dict(traversal="brute", gi_samples=2, gi_depth=1, normal_mode="smooth"),
                        {"env": True}),
}
RING_ENV = np.linspace(5.0, 80.0, 4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
RING_EXTRA_LIGHT = ((-4.0, 6.0, -2.0), 1.0)


def ring_case(name: str):
    """The prepared ring case `name` on the CPU."""
    from ray_tracer_tpu_torch.config import LightConfig
    from ray_tracer_tpu_torch.render.renderer import prepare

    over, change = RING_CASES[name]
    scene, cfg = _gradcheck(16, faithful=False, **over)
    if change.get("reflective"):
        scene = scene._replace(materials=scene.materials._replace(
            reflective=torch.tensor([False, True]), km=torch.tensor([0.0, 0.6])))
    if change.get("env"):
        scene = scene._replace(env_image=torch.from_numpy(RING_ENV.copy()))
    if change.get("extra_light"):
        pos, li = RING_EXTRA_LIGHT
        cfg = dataclasses.replace(cfg, extra_lights=(LightConfig(pos, li),))
    return prepare(cfg, scene=scene)


def ring_meshes(world: int, devices="cpu"):
    """(mesh, rays_axis) of the ring renders, and the two-axis mesh of the
    ring queries: world 2 on one "tris" axis and (1, 2), world 4 as
    (2, 2) ("rays", "tris") (the JAX tests' shapes)."""
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    two = make_mesh(world, ("rays", "tris"), shape=(world // 2, 2), devices=devices)
    if world == 2:
        return make_mesh(2, ("tris",), shape=(2,), devices=devices), None, two
    return two, "rays", two


RING_TRAINABLE = ("verts", "base_color", "km", "light_pos")


def ring_renders(rank: int, world: int) -> dict:
    """Every ring case through render_sharded_geometry, intersect_ring_sharded
    on the gradcheck scene's camera rays, trace_ring, the ring AOVs and AO,
    trace_pixel(mesh=) at three pixels, and `cli render --ring` on these
    ranks (rank 0's results)."""
    from ray_tracer_tpu_torch.ops.camera import camera_rays
    from ray_tracer_tpu_torch.parallel.shard import (
        intersect_ring_sharded,
        render_sharded_geometry,
        trace_ring,
    )
    from ray_tracer_tpu_torch.render.aov import render_ao, render_aovs
    from ray_tracer_tpu_torch.render.debug import trace_pixel

    mesh, rays_axis, two = ring_meshes(world)
    out = {"images": {}}
    for name in RING_CASES:
        out["images"][name] = _numpy(render_sharded_geometry(ring_case(name), mesh=mesh,
                                                             rays_axis=rays_axis))
    prep = ring_case("brute")
    rays = camera_rays(prep.cfg.camera, device="cpu")
    v0, v1, v2 = prep.scene.triangle_soa()
    res = intersect_ring_sharded(rays, v0, v1, v2, mesh, rays_axis=rays_axis, t_lower=1e-4)
    out["intersect"] = {k: _numpy(v) for k, v in res._asdict().items()}
    for name in ("packed", "brute"):
        prep = ring_case(name)
        b = trace_ring(prep, camera_rays(prep.cfg.camera, device="cpu"), two,
                       t_gate=prep.cfg.render.shadow_eps)
        out[f"trace_{name}"] = {k: _numpy(v) for k, v in b.items()}
        out[f"aovs_{name}"] = {k: _numpy(v) for k, v in render_aovs(prep, mesh=two,
                                                                     ring=True).items()}
        out[f"ao_{name}"] = _numpy(render_ao(prep, samples=6, radius=1.0, mesh=two, ring=True))
        out[f"pixel_{name}"] = [trace_pixel(prep, x, y, mesh=two)
                                for x, y in ((8, 8), (3, 12), (0, 0))]
    from ray_tracer_tpu_torch import cli

    path = os.path.join(OUT_DIR, f"ring{world}.ppm")
    cli.main(["render", "--scene", "serial", "--width", "16", "--turbo", "--devices",
              str(world), "--ring", "--out", path, "--device", "cpu"])
    from ray_tracer_tpu_torch.config import apply_turbo
    from ray_tracer_tpu_torch.io.ppm import write_ppm
    from ray_tracer_tpu_torch.models.scenes import serial_scene_config
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from ray_tracer_tpu_torch.render.renderer import prepare

    prep = prepare(apply_turbo(serial_scene_config(16, 16), "serial"), device="cpu")
    img = render_sharded_geometry(prep, mesh=make_mesh(world, ("tris",), shape=(world,),
                                                       devices="cpu"), rays_axis=None)
    want = os.path.join(OUT_DIR, f"ring{world}_direct.ppm")
    if rank == 0:
        write_ppm(want, _numpy(img))
    out["cli_ppm"], out["direct_ppm"] = path, want
    out["own_grid_equal"] = _own_ring_grids_equal(mesh, [ring_case("packed"), prep])
    return out if rank == 0 else None


def _own_ring_grids_equal(mesh, preps) -> list:
    """Every rank's `build_ring_shard` against its shard of
    `build_ring_grids` (meta, padded face count and every array's bytes),
    for each prep -> [[equal on rank 0, rank 1, ...] a prep]."""
    from ray_tracer_tpu_torch.parallel.collectives import all_gather
    from ray_tracer_tpu_torch.parallel.mesh import axis_index, axis_size
    from ray_tracer_tpu_torch.parallel.shard import build_ring_grids, build_ring_shard

    it = axis_index(mesh, "tris")
    out = []
    for prep in preps:
        own = build_ring_shard(prep, mesh)
        full = build_ring_grids(prep, axis_size(mesh, "tris"))
        equal = (own.meta == full.meta and own.fp == full.fp and own.first == it
                 and all(a.numpy().tobytes() == b[it:it + 1].numpy().tobytes()
                         for a, b in zip(own.arrays, full.arrays)))
        out.append([bool(x) for x in all_gather(torch.tensor(equal))])
    return out


RING_STEPS = (("packed", 2), ("brute", 2), ("packed_bounces", 1), ("brute_bounces", 1),
              ("brute_spp2", 1))


def ring_steps(rank: int, world: int) -> dict:
    """Ring train steps (SGD, lr 1e-3, RING_TRAINABLE) on the cases of
    RING_STEPS, each against the unsharded step from the same parameters
    (loss, every gradient), and the parameters of every rank after each
    step."""
    from ray_tracer_tpu_torch.opt import fit
    from ray_tracer_tpu_torch.parallel.collectives import all_gather

    mesh, rays_axis, _ = ring_meshes(world)
    target = torch.full((16, 16, 3), 40.0)
    out = {}
    for name, n_steps in RING_STEPS:
        if name == "brute_spp2":
            prep = ring_case("brute")
            prep = prep._replace(cfg=_rep(prep.cfg, spp=2))
        else:
            prep = ring_case(name)
        grid, meta = ((prep.packed.arrays, prep.packed.meta) if prep.packed is not None
                      else (prep.grid.arrays, prep.grid.meta))
        s_step, s_init, ring_scene = fit.make_ring_train_step(
            prep, mesh, rays_axis=rays_axis, optimizer="sgd", lr=1e-3, trainable=RING_TRAINABLE)
        u_step, u_init = fit.make_train_step(meta, prep.cfg, optimizer="sgd", lr=1e-3,
                                             trainable=RING_TRAINABLE)
        params, opt = s_init(fit.split_scene(prep.scene))
        steps = []
        for _ in range(n_steps):
            up, uo = u_init(fit.detached(params))
            _, _, u_loss = u_step(up, uo, prep.scene, grid, target, dda=prep.dda)
            params, opt, s_loss = s_step(params, opt, ring_scene, target)
            steps.append({
                "loss": float(s_loss), "unsharded_loss": float(u_loss),
                "grads": {f: _numpy(getattr(params, f).grad) for f in RING_TRAINABLE},
                "unsharded_grads": {f: _numpy(getattr(up, f).grad) for f in RING_TRAINABLE},
                "params": {f: _numpy(getattr(params, f)) for f in RING_TRAINABLE},
                "same_on_every_rank": all(
                    all(torch.equal(x.view(torch.int32),
                                    getattr(params, f).detach().view(torch.int32))
                        for x in all_gather(getattr(params, f).detach()))
                    for f in RING_TRAINABLE)})
        out[name] = steps
    return out


def _main(argv) -> int:
    global OUT_DIR
    fn, rank, world, init, out, threads = argv
    OUT_DIR = os.path.dirname(out)
    sys.path[:0] = [REPO, HERE]
    if int(threads):
        torch.set_num_threads(int(threads))
    from ray_tracer_tpu_torch.parallel import multihost

    if fn != "single_process":  # that one forms its own group
        multihost.initialize(init, int(world), int(rank), backend="gloo",
                             timeout=GROUP_TIMEOUT)
    try:
        result = globals()[fn](int(rank), int(world))
    finally:
        multihost.shutdown()
    with open(out, "wb") as fh:
        pickle.dump(result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))

