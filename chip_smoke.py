"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device.  Phases,
each printing one JSON line:

  1. device: PyTorch/CUDA versions, the card's name and power limit;
  2. build: compile every kernel of csrc/ (one nvcc per source, in
     parallel) and time it;
  3. kernel A (csrc/brute_intersect.cu) against its plain PyTorch version
     on the serial scene's 256x256 camera rays and their shadow rays:
     hit and tri_id equal, t bitwise equal;
  4. kernel B (csrc/traverse_grid.cu) against its plain version on the
     same rays, float32 and float64 determinants, faithful and production
     modes: all five TraceResult fields equal;
  5. the main path at full size: prepare + render of the serial scene at
     1024x1024 with the default config (the CSR DDA) and with
     traversal="brute_pallas"; launch counts are zeroed before each render
     and read after it, and each config must have launched its kernel;
     median time of 5 renders after a warm-up and Mrays/s (primary +
     shadow); the two images agree up to boundary pixels; the command
     line renders the default config's PPM bytes; one timed render of
     the 3-bounce parallel scene at 512x512;
  6. the serial scene at 64x64 with float64 determinants on the card gives
     the PPM bytes of the port's own CPU render (which the CPU tests pin
     to the C++ oracle).

Then the kernel times at the main path's shapes (1024x1024 camera rays:
the primary launch, which the `kernels` line reports beside its plain
version's time and its bound, and the shadow launch), a `kernels` line,
the card line, and last {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without a CUDA device it exits non-zero before any phase.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
# The FP32 peak counts a fused multiply-add as two operations; the kernels
# build with -fmad=false, so they issue at most half of it.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (ray, triangle) pair of kernel A, counted from
# ray_tracer_tpu/ops/pallas_intersect.py:65-83 with the common products
# shared: s (3), det A (11), t numerator (11), beta numerator (11), gamma
# numerator (5 beyond the shared terms), 1/A (1), three products (3),
# beta + gamma (1), and the five comparisons of the acceptance test.
OPS_PER_PAIR_A = 51
# FP32 operations per tested triangle of kernel B (cramer_tbg): the three
# columns (9), four determinants (44), three divisions (3), the pass test
# and the gate (5).
OPS_PER_TEST_B = 61


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """CUDA-event time of n back-to-back fn() calls over n, after one
    warm-up: the host's work in the wrapper overlaps the device's."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def kernel_device_ms(fn, kernel: str, n: int):
    """Mean device time of the CUDA kernels whose name holds `kernel` over
    n calls of fn() under torch.profiler; None if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type.name == "CUDA" and kernel in e.name]
    return sum(us) / len(us) / 1e3 if us else None


def once_ms(fn):
    """(CUDA-event time of one fn() call, its result)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def profile_render(prep, median_s: float) -> dict:
    """One render under torch.profiler: the device's busy time (the sum of
    kernel durations; kernels on one stream do not overlap), the idle
    share of the unprofiled median frame time that leaves, and the device
    time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tracer_tpu_torch.render.renderer import render

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(prep)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"phase": "main_path_profile", "config": "csr", "device_kernels": len(kernels),
            "device_busy_ms": busy_us / 1e3, "median_frame_ms": median_s * 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / (median_s * 1e3),
            "top_device_ms": {k[:60]: v / 1e3 for k, v in top}}


def compare(label: str, got, want) -> float:
    """Fields equal (floats bitwise); raise with a count and an example
    otherwise.  Returns the max |difference| of the float fields."""
    err = 0.0
    names = getattr(got, "_fields", None) or [str(i) for i in range(len(got))]
    for name, g, w in zip(names, got, want):
        if g.dtype == torch.float32:
            bad = g.view(torch.int32) != w.view(torch.int32)
            both = torch.isfinite(g) & torch.isfinite(w)
            if bool(both.any()):
                err = max(err, float((g[both] - w[both]).abs().max()))
        else:
            bad = g != w
        n = int(bad.sum())
        if n:
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"{label}: field {name} differs in {n} of {g.numel()} lanes; "
                f"lane {i}: kernel {g[i].item()!r}, plain {w[i].item()!r}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8
    from ray_tracer_tpu_torch.kernels import _build
    from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
    from ray_tracer_tpu_torch.ops import brute_intersect as kA
    from ray_tracer_tpu_torch.ops import traverse as kB
    from ray_tracer_tpu_torch.ops.camera import camera_rays
    from ray_tracer_tpu_torch.render.renderer import prepare, render, shadow_rays_for

    dev = torch.device("cuda")
    card = card_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "card": card,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    libs = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.basename(v) for k, v in libs.items()}})

    base = serial_scene_config(256, 256)
    prep = prepare(base)
    grid, meta = prep.grid.arrays, prep.grid.meta
    v0, v1, v2 = prep.scene.triangle_soa()
    tri9_soa = kA.triangle_table(v0, v1, v2)
    tri9_rows = kB.vertex_table(v0, v1, v2)
    n_tris = v0.shape[0]

    def shadow_of(cfg, rays, t, hit):
        poi = torch.where(hit[:, None], rays.at(torch.where(hit, t, torch.zeros_like(t))),
                          torch.zeros_like(rays.orig))
        return shadow_rays_for(cfg.render, prep.scene.light_pos, poi, hit)

    # ---- 3. kernel A vs its plain version -------------------------------
    err_a = 0.0
    rays = camera_rays(base.camera, device=dev)
    ka = kA.brute_intersect_cuda(rays.orig, rays.dirn, tri9_soa, 0.0)
    pa = kA.brute_intersect_plain(rays.orig, rays.dirn, tri9_soa, 0.0)
    err_a = max(err_a, compare("kernel A primary", ka, pa))
    hit = ka[1] >= 0
    srays = shadow_of(dataclasses.replace(base, render=dataclasses.replace(
        base.render, faithful=False)), rays, ka[0], hit)
    eps = base.render.shadow_eps
    ks = kA.brute_intersect_cuda(srays.orig, srays.dirn, tri9_soa, eps)
    ps = kA.brute_intersect_plain(srays.orig, srays.dirn, tri9_soa, eps)
    err_a = max(err_a, compare("kernel A shadow", ks, ps))
    emit({"phase": "kernel_A_vs_plain", "rays": rays.count, "triangles": n_tris,
          "primary_hits": int(hit.sum()), "shadow_hits": int((ks[1] >= 0).sum()),
          "max_abs_err": err_a, "tolerance": "bitwise", "equal": True})

    # ---- 4. kernel B vs its plain version -------------------------------
    err_b = 0.0
    checked = []
    for det in ("float32", "float64"):
        for mode, kw, skw in (
            ("faithful", dict(t_gate=None), dict(t_gate=eps)),
            ("production", dict(t_gate=0.0, early_exit=True),
             dict(t_gate=eps, early_exit=True, stop_on_first_hit=True)),
        ):
            kb = kB.traverse_grid_cuda(rays, grid, meta, tri9_rows, det_dtype=det, **kw)
            pb = kB.traverse_grid_plain(rays, grid, meta, tri9_rows, det_dtype=det, **kw)
            err_b = max(err_b, compare(f"kernel B {det} {mode} primary", kb, pb))
            h = kb.any_pass if mode == "faithful" else kb.hit
            sr = shadow_of(base, rays, kb.t, h)
            kbs = kB.traverse_grid_cuda(sr, grid, meta, tri9_rows, det_dtype=det, **skw)
            pbs = kB.traverse_grid_plain(sr, grid, meta, tri9_rows, det_dtype=det, **skw)
            err_b = max(err_b, compare(f"kernel B {det} {mode} shadow", kbs, pbs))
            checked.append({"det": det, "mode": mode, "primary_hits": int(h.sum()),
                            "shadow_hits": int(kbs.hit.sum()),
                            "mean_steps": float(kb.steps.float().mean())})
    emit({"phase": "kernel_B_vs_plain", "rays": rays.count, "cases": checked,
          "max_abs_err": err_b, "tolerance": "bitwise", "equal": True})

    # ---- 5. the main path at full size ----------------------------------
    size = 1024
    main_cfg = serial_scene_config(size, size)
    configs = {
        "csr": (main_cfg, "traverse_grid"),
        "brute_pallas": (dataclasses.replace(main_cfg, render=dataclasses.replace(
            main_cfg.render, traversal="brute_pallas", faithful=False)), "brute_intersect"),
    }
    counters = {"brute_intersect": kA.brute_intersect_cuda, "traverse_grid": kB.traverse_grid_cuda}
    launches = {}
    images = {}
    for name, (cfg, kernel) in configs.items():
        t0 = time.perf_counter()
        p = prepare(cfg)
        prep_s = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        img = render(p)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        if counts[kernel] <= 0:
            raise AssertionError(f"render with traversal={name} launched {kernel} 0 times")
        launches[kernel] = counts[kernel]
        if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name} render: bad image {tuple(img.shape)}")
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            img = render(p)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = sorted(secs)[2]
        images[name] = tonemap_u8(img.cpu().numpy())
        emit({"phase": "main_path", "config": name, "size": size,
              "prepare_s": prep_s, "median_ms": med * 1e3,
              "renders_ms": [s * 1e3 for s in secs],
              "mrays_per_s": size * size * 2 / med / 1e6,
              "launches_per_frame": counts,
              "lit_pixels": int((images[name].max(axis=-1) > 0).sum())})
        if name == "csr":
            emit(profile_render(p, med))
    diff = abs(images["csr"].astype(int) - images["brute_pallas"].astype(int)).max(axis=-1)
    frac = float((diff > 2).mean())
    if frac >= 0.01:
        raise AssertionError(f"csr vs brute_pallas: {frac:.2%} of pixels differ by > 2")
    emit({"phase": "main_path_agreement", "pixels_over_2_counts": frac})

    # the same default render through the command line, in its own process
    root = os.path.dirname(os.path.abspath(__file__))
    out_ppm = os.path.join(root, "build", "chip_smoke_cli.ppm")
    os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
    cli = subprocess.run(
        [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "serial",
         "--width", str(size), "--out", out_ppm],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    if cli.returncode != 0:
        raise AssertionError(f"cli render failed:\n{cli.stderr[-3000:]}")
    cli_img = read_ppm(out_ppm)
    if not (cli_img == images["csr"]).all():
        raise AssertionError("cli render differs from the in-process render")
    emit({"phase": "cli", "size": size, "same_bytes_as_render": True,
          "stderr": cli.stderr.strip().splitlines()[-1]})

    pcfg = parallel_scene_config(512, 512)
    pp = prepare(pcfg)
    for fn in counters.values():
        fn.launches = 0
    render(pp)
    torch.cuda.synchronize()
    pcounts = {k: fn.launches for k, fn in counters.items()}
    if pcounts["traverse_grid"] <= 0:
        raise AssertionError("parallel render launched traverse_grid 0 times")
    t0 = time.perf_counter()
    pimg = render(pp)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(pimg).all()):
        raise AssertionError("parallel render: non-finite pixels")
    emit({"phase": "parallel_scene", "size": 512, "triangles": pp.scene.num_faces,
          "bounces": pcfg.render.max_bounces, "ms": pms,
          "launches_per_frame": pcounts})

    # ---- kernel times at the main path's shapes -------------------------
    p = prepare(main_cfg)
    grid, meta = p.grid.arrays, p.grid.meta
    v0, v1, v2 = p.scene.triangle_soa()
    tri9_soa = kA.triangle_table(v0, v1, v2)
    tri9_rows = kB.vertex_table(v0, v1, v2)
    rays = camera_rays(main_cfg.camera, device=dev)
    r = rays.count

    # Inputs are made once; each kernel's time is n back-to-back launches
    # over n, its device time the profiler's mean for the kernel alone.
    def launch_a():
        return kA.brute_intersect_cuda(rays.orig, rays.dirn, tri9_soa, 0.0)

    a_ms = cuda_ms(launch_a, 5)
    a_dev_ms = kernel_device_ms(launch_a, "brute_intersect_kernel", 3)
    a_out = launch_a()
    a_plain_ms, a_plain = once_ms(
        lambda: kA.brute_intersect_plain(rays.orig, rays.dirn, tri9_soa, 0.0))
    err_a = max(err_a, compare("kernel A 1024 primary", a_out, a_plain))
    a_ops = r * n_tris * OPS_PER_PAIR_A
    a_bytes = r * (24 + 8) + n_tris * 36
    a_bound = max(a_ops / PEAK_FP32_OPS, a_bytes / PEAK_BYTES) * 1e3

    kw = dict(det_dtype=main_cfg.render.det_dtype, t_gate=main_cfg.render.primary_gate(),
              early_exit=not main_cfg.render.faithful)

    def launch_b():
        return kB.traverse_grid_cuda(rays, grid, meta, tri9_rows, **kw)

    b_ms = cuda_ms(launch_b, 50)
    b_dev_ms = kernel_device_ms(launch_b, "traverse_grid_kernel", 20)
    tested = torch.zeros((r,), dtype=torch.int32, device=dev)
    b_out = kB.traverse_grid_cuda(rays, grid, meta, tri9_rows, tested_out=tested, **kw)
    b_plain_ms, b_plain = once_ms(
        lambda: kB.traverse_grid_plain(rays, grid, meta, tri9_rows, **kw))
    err_b = max(err_b, compare("kernel B 1024 primary", b_out, b_plain))
    # the frame's second launch of each kernel: the shadow rays of its hits
    fast = dataclasses.replace(main_cfg, render=dataclasses.replace(main_cfg.render, faithful=False))
    sa = shadow_of(fast, rays, a_out[0], a_out[1] >= 0)
    a_shadow_ms = cuda_ms(lambda: kA.brute_intersect_cuda(sa.orig, sa.dirn, tri9_soa, eps), 5)
    sb = shadow_of(main_cfg, rays, b_out.t, main_cfg.render.accepted_hit(b_out))
    b_shadow_ms = cuda_ms(lambda: kB.traverse_grid_cuda(
        sb, grid, meta, tri9_rows, det_dtype=kw["det_dtype"], t_gate=eps,
        early_exit=kw["early_exit"], stop_on_first_hit=kw["early_exit"]), 50)
    n_tests = int(tested.sum())
    n_steps = int(b_out.steps.sum())
    # each input read once, each output written once: the rays (32 B) and
    # five results (14 B), the CSR arrays and the vertex table; the walk's
    # repeated gathers of them are not counted
    b_bytes = (r * (32 + 14) + (grid.cell_start.numel() + grid.tri_ids.numel()) * 4
               + tri9_rows.numel() * 4)
    b_ops = n_tests * OPS_PER_TEST_B
    b_bound = max(b_bytes / PEAK_BYTES, b_ops / PEAK_FP32_OPS) * 1e3
    emit({"phase": "kernel_times", "rays": r, "triangles": n_tris,
          "A": {"ms": a_ms, "device_ms": a_dev_ms, "shadow_ms": a_shadow_ms,
                "plain_ms": a_plain_ms, "ops": a_ops, "bytes": a_bytes, "bound_ms": a_bound,
                "bound_unfused_ms": a_ops / (PEAK_FP32_OPS / 2) * 1e3},
          "B": {"ms": b_ms, "device_ms": b_dev_ms, "shadow_ms": b_shadow_ms,
                "plain_ms": b_plain_ms, "steps": n_steps, "tested_triangles": n_tests,
                "bytes": b_bytes, "ops": b_ops, "bound_ms": b_bound}})

    # ---- 6. card vs CPU --------------------------------------------------
    small = serial_scene_config(64, 64)
    small = dataclasses.replace(small, render=dataclasses.replace(small.render, det_dtype="float64"))
    on_card = tonemap_u8(render(prepare(small)).cpu().numpy())
    on_cpu = tonemap_u8(render(prepare(small, device="cpu")).numpy())
    n_bad = int((on_card != on_cpu).sum())
    if n_bad:
        raise AssertionError(f"64x64 float64 render: {n_bad} PPM bytes differ card vs CPU")
    emit({"phase": "card_vs_cpu", "size": 64, "det_dtype": "float64", "bytes_differing": 0})

    emit({"kernels": [
        {"name": "brute_intersect", "route": "cuda",
         "source": "ray_tracer_tpu_torch/csrc/brute_intersect.cu",
         "replaces": "ray_tracer_tpu/ops/pallas_intersect.py:114",
         "launches": launches["brute_intersect"], "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound,
         "bound_by": "operations" if a_ops / PEAK_FP32_OPS >= a_bytes / PEAK_BYTES else "bytes",
         "library_ms": None},
        {"name": "traverse_grid", "route": "cuda",
         "source": "ray_tracer_tpu_torch/csrc/traverse_grid.cu",
         "replaces": "ray_tracer_tpu/ops/traverse.py:91",
         "launches": launches["traverse_grid"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": "bytes" if b_bytes / PEAK_BYTES >= b_ops / PEAK_FP32_OPS else "operations",
         "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
