"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,C,E # a subset, for a quick check

Run from the repository root on a machine with a CUDA device.  Phases,
each printing one JSON line:

  1. device: PyTorch/CUDA versions, the card's name and power limit;
  2. build: compile every kernel of csrc/ (one nvcc per source, in
     parallel) and time it; registers and spills of every kernel;
  3. kernel A (csrc/brute_intersect.cu) against its plain PyTorch version
     on the serial scene's 256x256 camera rays and their shadow rays:
     hit and tri_id equal, t bitwise equal;
  4. kernel B (csrc/traverse_grid.cu) against its plain version on the
     same rays and on the parallel scene's grid and camera, float32 and
     float64 determinants, faithful and production modes: all five
     TraceResult fields equal;
  5. kernel C (csrc/packed_march.cu) against its plain version on the
     turbo serial grid's 256x256 camera rays, one lane per ray and on the
     compacted and the chord-ordered queues (directly and through
     persistent_trace): fused with and without the dead-shadow skip,
     nearest and any hit, inline and blocks layouts (and a probe chain),
     rows of 14, 28 and 56 triangles: every record field bitwise equal,
     no ray capped;
  6. kernel E (csrc/whitted_wave.cu) against its plain version: the turbo
     parallel scene at 256x256, the serial scene at 256x256 with
     whitted_wave="on", the parallel scene at 128x128 with spp 2, and with
     spp 2 and a lens (aperture 0.25, focus 20): the camera rays E makes
     bitwise equal to the CPU batch (which the plain version traces),
     colors bitwise equal, every counter equal, no lane capped;
  7. the main path at full size, launch counts zeroed before each render
     and read after it, each config required to launch its kernel:
     prepare + render of the serial scene at 1024x1024 with the default
     config (csr), traversal="brute_pallas" and the tuned production
     config (config.apply_turbo: packed grid, persistent fused march);
     median of 5 renders after a warm-up and Mrays/s (primary + shadow);
     the images agree with the csr image up to boundary pixels; the
     command line renders the csr and the --turbo PPM bytes; the turbo
     parallel scene at 1024x1024 through the cross-depth Whitted wave (one
     launch of E a frame and none of C; median of 5, each frame under
     torch.cuda.set_sync_debug_mode("error"), so that a device-to-host
     copy or a synchronisation inside render raises; the profile's device
     kernels, pixels and segments marched a second of frame; E's camera
     rays against the CPU batch; its image against the bounce loop's, 4
     launches of C, by the 2-count rule; the command line's PPM bytes);
     one timed render of the 3-bounce parallel scene at 512x512, csr and
     turbo (whitted_wave="off");
  8. card vs CPU: the 64x64 float64 csr render gives the PPM bytes of the
     port's own CPU render; the 64x64 turbo march gives the CPU's per-ray
     records, and its image differs by more than 2 counts on under 1% of
     pixels; so does the 64x64 turbo parallel image through the wave, and
     where its floats differ, the pow inputs of those pixels are taken on
     both devices (the plain wave on the card with pow on the CPU gives
     the CPU's colors);
  9. kernel D (csrc/gather_row_test.cu) against its plain version through
     the port's gather tool, and the tool's step-loop time;
 10. kernel F (csrc/gi_wave.cu, the cross-depth GI wave: stage P, the
     persistent stage S and the fold) against its plain version on the
     card: the turbo serial scene at 128x128 with S = 4, D = 2, the turbo
     parallel scene (the mirror mix) at 128x128 with S = 2, D = 3, the
     escape-only plane, D = 0, 100x75 pixels with S = 3, D = 2 (the
     queues' tails) and S = 8, D = 1 (the fold's order): the radiance
     bitwise equal and every counter equal, no pixel capped.  In phase 7
     (main) the path-traced render: the official GI row (turbo serial,
     1024x1024, S = 4, D = 2) through prepare + render, one call of F a
     frame and nothing else, each frame under
     torch.cuda.set_sync_debug_mode("error"), Mpaths/s and F's segments a
     second, the ten-frame profile and the CUDA kernels a frame runs; the GI
     wave against the segment integrator at 256x256 (the serial and
     parallel scenes, the JAX package's statistical rule); the command
     line's GI PPM; and the turbo nefertiti scene at 1024x1024 (kernel C,
     the tuned knobs) against its csr image (kernel B) by the 2-count rule.
     Every launch of C that the segment integrator and the nefertiti
     frame make is logged and held, at its own inputs, to the plain
     version: records bitwise, the rows tested and touched, the capped
     lanes and the most steps equal.  Each path's launch counts on a line
     of their own.  In phase 8 the 64x64 GI wave renders, card against
     CPU, bitwise; and the 64x64 segment integrator over the csr grid
     (S = 2, D = 1, the command line's default GI): each launch of B held
     to the plain version (records bitwise, rows tested equal) and the
     image against the CPU's by the 2-count rule.
 11. the appearance epilogues (phase appearance): kernel F's feature
     instantiations (csrc/texture.cuh; environment map, smooth normals,
     checker or image texture) against the plain version on ten cases at
     64x64 to 128x128 (the env furnace, a non-constant map, smooth normals
     on the plane and the gradcheck scene, both textures at depth 0 and 1,
     every feature with the mirror mix on a quad and on the parallel
     scene), radiance and every counter bitwise; the official GI row with
     smooth normals, a 256x256 image texture and a 256x512 environment
     map (numpy, fixed seed) through prepare + render, one call of F a
     frame, held bitwise to the plain version, timed beside the
     featureless row (median of 5 frames under the sync debug mode, the
     profile's busy time, F's device time) with ptxas's registers of every
     instantiation (the featureless stages must not spill); and the turbo
     serial Whitted bounce loop with all three at 1024x1024 (kernel C, not
     E), card against CPU at 64x64 by the 2-count rule.
 12. the train step (phase train): BASELINE config 4, the turbo nefertiti
     scene at 1024x1024 with verts, base_color, kd, ks, ka and light_pos
     trainable, 6 steps of opt.fit.fit (Adam, lr 1e-2) against the
     self-demo target (kd x 1.5, base_color x 0.6) with a grid rebuild
     after step 3: launch counts zeroed before the fit and read after it
     (C launched), the losses finite and falling, each step's CUDA-event
     time (the median of the steps after the first), Mrays/s forward +
     backward at 2 rays a pixel, the rebuild's seconds, the peak device
     memory, a three-step profiler window's busy time and idle share;
     kernel C's launch on the first step held to its plain version
     bitwise; the forward under autograd bitwise render()'s image (the
     nefertiti scene, and the gradcheck scene at 64x64 with soft
     visibility and soft primary); on that gradcheck scene the loss card
     against CPU to rtol 1e-6 and every gradient leaf to rtol 1e-4, atol
     1e-6 max|g|; the soft-primary silhouette gradient of one triangle at
     16x16 against central differences (rtol 5e-2).

Then the kernel times at the main path's shapes (each launch held
bitwise to the plain version; B's, C's and E's barycentric passes, and
E's camera rays, vertices and reflections, counted for their operation
bounds; C's device time against its time before the shared header; E's
lane utilisation before and after its redesign, on lines of their own;
F's device time as the sum of its kernels and memset, each stage's
beside it, its lane utilisation before and after its redesign, its
events over launches, its plain version once and its bound from its
counters, with ptxas's registers and spills),
a `kernels` line, the card line, and last {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; without a CUDA device it exits
non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
# The FP32 peak counts a fused multiply-add as two operations; the kernels
# build with -fmad=false, so they issue at most half of it.
PEAK_FP32_OPS = 67e12
PEAK_FP32_UNFUSED = PEAK_FP32_OPS / 2
PEAK_BYTES = 3.35e12
# FP32 operations per (ray, triangle) pair of kernel A, counted from
# ray_tracer_tpu/ops/pallas_intersect.py:65-83 with the common products
# shared: s (3), det A (11), t numerator (11), beta numerator (11), gamma
# numerator (5 beyond the shared terms), 1/A (1), three products (3),
# beta + gamma (1), and the five comparisons of the acceptance test.
OPS_PER_PAIR_A = 51
# FP32 operations per tested triangle of kernels B and C (cramer.cuh
# cramer_pass_t, 11 a determinant as for A and D): one that fails the
# barycentric test takes the three columns (9), the determinant A and
# beta's and gamma's numerators (33), two divisions (2) and the test (4);
# one that passes adds t's numerator (11), its division (1) and the gate
# (1).  The kernels count the passes of this run's data.
OPS_PER_FAILED_TEST = 48
OPS_PER_PASSED_TEST = 61
# FP32 operations per triangle lane of kernel D, counted as for B: the
# columns (9), four determinants (44), 1/A (1), three products (3), the
# acceptance test (5) and the running minimum (1).
OPS_PER_LANE_D = 63
# FP32 operations per vertex of kernel E beyond its slot tests (counted as
# for C), from csrc/whitted_wave.cu with a normalize at 10 (length 5, sqrt,
# reciprocal, three products) and powf at 3 (lg2, multiply, ex2): the
# recomputed t (columns 9, two determinants 22, the division), the two hit
# points (12), the normal (edges 6, cross 9), the view and light directions
# (3 + 10 each), h (3 + 10, normalized in the parallel variant), n.l and
# n.h with their max (12), powf, A and B (21 in the parallel variant); the
# shadow ray (light - poi 3, length 6, divisions 3) and its slab entry (30:
# three reciprocals, six subtractions, six products, the min/max folds);
# and the blend (color 6, tint and 1 - km 7, the weighted sum 6).
OPS_PER_VERTEX_E = 195
# ... and per reflection: the normalized incident direction and normal
# (20), the dot and its double (6), nn * two and the subtraction (6), the
# normalized result (10), the slab entry (30), the weight (1) and an
# escape's background (6).
OPS_PER_REFLECTION_E = 79
# ... and per camera ray it makes (csrc/camera.cuh, the pinhole): xw (4) and
# yw (3), the direction (a negation, three products and two sums a
# component: 18), its normalize (10), and the primary's reciprocal
# direction (3) and slab entry (30).
OPS_PER_CAMERA_RAY_E = 68
# FP32 operations of kernel F beyond its slot tests, counted from
# csrc/gi_wave.cu as for E (a normalize at 10, a hash at 14 integer
# operations, float64 cos and sin at one each): per vertex the recomputed t
# (32), the two hit points (12), the oriented face normal (33), the NEE
# terms (31), the branch draw (14), the shadow direction (12) and its slab
# entry (30), the banked NEE (3): 167; per bounce or restart the key and
# two draws (30), the basis (16), the cosine sample (24), the mirror
# (12), the slab entry (30) and the throughput and reciprocal direction
# (6): 118, counted for the bounces that entered the grid; per escape the
# background term (6) alone; per pixel the camera ray (68, as for E), its
# key (11) and the sum of its S samples (3 each).
OPS_PER_VERTEX_F = 167
OPS_PER_BOUNCE_F = 118
OPS_PER_ESCAPE_F = 6
OPS_PER_PIXEL_F = 79
OPS_PER_SAMPLE_F = 3
ALL_PHASES = ("build", "A", "B", "C", "E", "F", "main", "card_vs_cpu", "appearance", "train",
              "D", "times")
# The kernels' device times on the 1024^2 main path before this version
# of the sources (B and C as redesigned, before C's march step moved into
# csrc/packed_step.cuh), NVIDIA H100 80GB HBM3 at 700 W, as recorded in
# PERF.md; C's must stay within 5%.
PREVIOUS_MS = {"B": {"device_ms": 0.4504}, "C": {"device_ms": 0.4288}}
# Kernel E on the turbo parallel 1024^2 frame before its redesign as a
# persistent wave (one thread a queue position, the camera batch in
# memory), on the same card as recorded in PERF.md: device time and lane
# utilisation (active lane-steps over 32 x warp loop iterations).
PREVIOUS_E = {"device_ms": 1.8276, "lane_utilisation": 0.7347491342129305}
# Kernel F on the official GI row (turbo serial 1024^2, S 4, D 2) before its
# redesign (one thread a pixel serving all its samples, no queue), on the
# same card as recorded in PERF.md: device time, lane utilisation (active
# lane-steps over 32 x warp loop iterations) and the share of warp steps
# in which a lane ended a segment.
PREVIOUS_F = {"device_ms": 1.1417, "lane_utilisation": 0.5449485670180693,
              "transition_share": 0.6849817278403751}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def calls_device_ms(fn, n: int, kernel: str = ""):
    """Device time of one fn() call from n calls under torch.profiler: the
    kernels and memsets whose name holds `kernel` summed, and the same by
    name; (None, {}) if the profiler saw none.  The profiler can drop a
    few of a window's events, so a name's launches a call are the ceiling
    of its events over n, each at its mean duration."""
    from ray_tracer_tpu_torch.tools.profiling import profiled_kernels

    kernels, _ = profiled_kernels(fn, n)
    by_name = {}
    for e in kernels:
        if kernel in e.name:
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    per_call = {k: -(-len(v) // n) * sum(v) / len(v) / 1e3 for k, v in by_name.items()}
    if not per_call:
        return None, {}
    return sum(per_call.values()), per_call


def once_ms(fn):
    """(CUDA-event time of one fn() call, its result)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


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


def ptxas_usage(lib_path: str) -> dict:
    """Registers and spill bytes per kernel from the build's -Xptxas -v log,
    keyed by the kernel's name and its mangled template arguments (e.g.
    traverse_grid_kernelIdEE: double determinants)."""
    with open(lib_path + ".log") as fh:
        log = fh.read()
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(I\w*?EE)?", m.group(1))
            name = k.group(1) + (k.group(2) or "") if k else m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {})["stack_frame"] = int(m.group(1))
            out[name]["spill_stores"] = int(m.group(2))
            out[name]["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def image_rule(a, b) -> float:
    """Share of pixels whose channels differ by more than 2 counts."""
    diff = abs(a.astype(int) - b.astype(int)).max(axis=-1)
    return float((diff > 2).mean())


class Logged:
    """Stands in for a kernel's wrapper in the module that calls it: each
    call's inputs and records (cloned, so that later frames, or a fit's
    in-place updates of the light, cannot change them) go to `log`; the
    launch count stays the wrapped function's."""

    def __init__(self, fn, kernel: str, log: list):
        self.fn, self.kernel, self.log = fn, kernel, log

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, rays, *args, **kw):
        from ray_tracer_tpu_torch.core.rays import RayBatch

        out = self.fn(rays, *args, **kw)
        kept = {k: v.clone() if k == "queue" and v is not None else v for k, v in kw.items()}
        args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        self.log.append((self.kernel, RayBatch(*(x.clone() for x in rays)), args, kept,
                         type(out)(*(x.clone() for x in out))))
        return out


class Smoke:
    """The phases share the card, the imports and what each phase measured
    for the `kernels` line."""

    def __init__(self):
        from ray_tracer_tpu_torch.ops import brute_intersect as kA
        from ray_tracer_tpu_torch.ops import traverse as kB
        from ray_tracer_tpu_torch.ops import traverse_packed as kC
        from ray_tracer_tpu_torch.ops import gi_wave as kF
        from ray_tracer_tpu_torch.ops import whitted_wave as kE
        from ray_tracer_tpu_torch.tools import gather_bench as kD

        self.kA, self.kB, self.kC, self.kD, self.kE, self.kF = kA, kB, kC, kD, kE, kF
        self.counters = {"brute_intersect": kA.brute_intersect_cuda,
                         "traverse_grid": kB.traverse_grid_cuda,
                         "packed_march": kC.march_cuda,
                         "gather_row_test": kD.gather_row_test_cuda,
                         "whitted_wave": kE.whitted_wave_cuda,
                         "gi_wave": kF.gi_wave_cuda}
        self.dev = torch.device("cuda")
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.launches = {}
        self.err = {"brute_intersect": 0.0, "traverse_grid": 0.0, "packed_march": 0.0,
                    "gather_row_test": 0.0, "whitted_wave": 0.0, "gi_wave": 0.0}
        self.times = {}
        self.images = {}
        self.libs = {}
        self.ptxas = {}
        self.wave_frame = None  # (cfg, prepared) of the turbo parallel 1024^2 frame
        self.gi_frame = None  # the prepared official GI row (turbo serial 1024^2, S 4, D 2)
        self.path_launches = {}  # each main-path render's launch counts
        self.nef_prep = None  # the prepared turbo nefertiti 1024^2 scene (BASELINE config 4)

    def zero_counts(self):
        for fn in self.counters.values():
            fn.launches = 0

    def counts(self):
        return {k: fn.launches for k, fn in self.counters.items()}

    @contextlib.contextmanager
    def logging_launches(self):
        """Log every launch of kernels B and C that the port makes inside
        the block (through traverse.traverse_grid, traverse_packed.march
        and persistent.persistent_trace)."""
        from ray_tracer_tpu_torch.ops import persistent, traverse, traverse_packed

        log = []
        sites = ((traverse, "traverse_grid_cuda", "traverse_grid"),
                 (traverse_packed, "march_cuda", "packed_march"),
                 (persistent, "march_cuda", "packed_march"))
        saved = [(module, name, getattr(module, name)) for module, name, _ in sites]
        try:
            for (module, name, kernel), (_, _, fn) in zip(sites, saved):
                setattr(module, name, Logged(fn, kernel, log))
            yield log
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)

    def hold_logged(self, label, log) -> dict:
        """Each logged launch of B or C again, with its counters, and its
        plain version on the same inputs: the new launch gives the logged
        records' bits, the plain version's records bitwise, and each
        counter the plain version keeps equal.  Returns, by kernel, the
        launches, rays, hits and capped lanes held."""
        from ray_tracer_tpu_torch.ops.persistent import _march_queued

        i32 = dict(dtype=torch.int32, device=self.dev)
        held = {}
        for i, (kernel, rays, args, kw, logged) in enumerate(log):
            r = rays.count
            where = f"{label}: launch {i} of {kernel}"
            if kernel == "traverse_grid":
                grid, meta, tri9 = args
                base = {k: v for k, v in kw.items()
                        if k not in ("tested_out", "passes_out", "tables")}
                tk, tp = torch.zeros((r,), **i32), torch.zeros((r,), **i32)
                got = self.kB.traverse_grid_cuda(rays, grid, meta, tri9, tables=kw.get("tables"),
                                                 tested_out=tk, **base)
                want = self.kB.traverse_grid_plain(rays, grid, meta, tri9, tested_out=tp, **base)
                counters = {"tested": (tk, tp)}
                capped = 0
            else:
                grid, meta, light = args
                base = {k: v for k, v in kw.items()
                        if k not in ("queue", "n_work", "consts", "tested_out", "touched_out",
                                     "capped_out", "iters_out", "passes_out")}
                ck, cp = ({"tested_out": torch.zeros((r,), **i32),
                           "touched_out": torch.zeros((meta.n_blocks,), **i32),
                           "capped_out": torch.zeros((1,), **i32)} for _ in range(2))
                iters = torch.zeros((1,), **i32)
                queue, n_work = kw.get("queue"), kw.get("n_work")
                got = self.kC.march_cuda(rays, grid, meta, light, queue=queue, n_work=n_work,
                                         consts=kw.get("consts"), iters_out=iters, **ck, **base)
                if queue is None:
                    want = self.kC.march_plain(rays, grid, meta, light, **cp, **base)
                else:
                    n_work = queue.shape[0] if n_work is None else int(n_work)
                    want = _march_queued(rays, grid, meta, light, (queue, n_work),
                                         cp["tested_out"], dict(base,
                                                                touched_out=cp["touched_out"],
                                                                capped_out=cp["capped_out"]))
                most = torch.full((1,), int(want.steps.max()) if r else 0, **i32)
                counters = {k[:-4]: (ck[k], cp[k]) for k in ck}
                counters["most_steps"] = (iters, most)
                capped = int(ck["capped_out"].item())
            torch.cuda.synchronize()
            compare(f"{where} again", got, logged)
            self.err[kernel] = max(self.err[kernel], compare(f"{where} vs plain", got, want))
            for name, (k, p) in counters.items():
                if not torch.equal(k, p):
                    raise AssertionError(f"{where}: counter {name} differs from the plain "
                                         "version's")
            row = held.setdefault(kernel, {"launches": 0, "rays": 0, "hits": 0, "capped": 0})
            row["launches"] += 1
            row["rays"] += r
            row["hits"] += int(want.hit.sum())
            row["capped"] += capped
        return held

    # ---- 2. build ----------------------------------------------------------
    def build(self):
        from ray_tracer_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        self.libs = _build.build()
        secs = time.perf_counter() - t0
        self.ptxas = {k: ptxas_usage(v) for k, v in self.libs.items()}
        emit({"phase": "build", "seconds": secs, "libraries": len(self.libs),
              "ptxas": self.ptxas})

    # ---- 3. and 4. kernels A and B vs their plain versions ---------------
    def kernels_ab(self, which):
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.render.renderer import prepare, shadow_rays_for

        kA, kB = self.kA, self.kB
        base = serial_scene_config(256, 256)
        prep = prepare(base)
        grid, meta = prep.grid.arrays, prep.grid.meta
        v0, v1, v2 = prep.scene.triangle_soa()
        tri9_soa = kA.triangle_table(v0, v1, v2)
        tri9_rows = kB.vertex_table(v0, v1, v2)
        n_tris = v0.shape[0]
        eps = base.render.shadow_eps
        rays = camera_rays(base.camera, device=self.dev)

        def shadow_of(cfg, t, hit):
            poi = torch.where(hit[:, None], rays.at(torch.where(hit, t, torch.zeros_like(t))),
                              torch.zeros_like(rays.orig))
            return shadow_rays_for(cfg.render, prep.scene.light_pos, poi, hit)

        if "A" in which:
            ka = kA.brute_intersect_cuda(rays.orig, rays.dirn, tri9_soa, 0.0)
            pa = kA.brute_intersect_plain(rays.orig, rays.dirn, tri9_soa, 0.0)
            err = compare("kernel A primary", ka, pa)
            hit = ka[1] >= 0
            srays = shadow_of(dataclasses.replace(base, render=dataclasses.replace(
                base.render, faithful=False)), ka[0], hit)
            ks = kA.brute_intersect_cuda(srays.orig, srays.dirn, tri9_soa, eps)
            ps = kA.brute_intersect_plain(srays.orig, srays.dirn, tri9_soa, eps)
            err = max(err, compare("kernel A shadow", ks, ps))
            self.err["brute_intersect"] = max(self.err["brute_intersect"], err)
            emit({"phase": "kernel_A_vs_plain", "rays": rays.count, "triangles": n_tris,
                  "primary_hits": int(hit.sum()), "shadow_hits": int((ks[1] >= 0).sum()),
                  "max_abs_err": err, "tolerance": "bitwise", "equal": True})

        if "B" in which:
            from ray_tracer_tpu_torch.models.scenes import parallel_scene_config

            err = 0.0
            checked = []
            pcfg = parallel_scene_config(256, 256)
            pprep = prepare(pcfg)
            prays = camera_rays(pcfg.camera, device=self.dev)
            for scene, cfg, p, rs in (("serial", base, prep, rays),
                                      ("parallel", pcfg, pprep, prays)):
                g, m = p.grid.arrays, p.grid.meta
                rows = kB.vertex_table(*p.scene.triangle_soa())
                s_eps = cfg.render.shadow_eps

                def shadow_b(t, hit, p=p, rs=rs, cfg=cfg):
                    poi = torch.where(hit[:, None], rs.at(torch.where(hit, t, torch.zeros_like(t))),
                                      torch.zeros_like(rs.orig))
                    return shadow_rays_for(cfg.render, p.scene.light_pos, poi, hit)

                for det in ("float32", "float64"):
                    for mode, kw, skw in (
                        ("faithful", dict(t_gate=None), dict(t_gate=s_eps)),
                        ("production", dict(t_gate=0.0, early_exit=True),
                         dict(t_gate=s_eps, early_exit=True, stop_on_first_hit=True)),
                    ):
                        label = f"kernel B {scene} {det} {mode}"
                        kb = kB.traverse_grid_cuda(rs, g, m, rows, det_dtype=det,
                                                   tables=p.dda, **kw)
                        pb = kB.traverse_grid_plain(rs, g, m, rows, det_dtype=det, **kw)
                        err = max(err, compare(f"{label} primary", kb, pb))
                        h = kb.any_pass if mode == "faithful" else kb.hit
                        sr = shadow_b(kb.t, h)
                        kbs = kB.traverse_grid_cuda(sr, g, m, rows, det_dtype=det,
                                                    tables=p.dda, **skw)
                        pbs = kB.traverse_grid_plain(sr, g, m, rows, det_dtype=det, **skw)
                        err = max(err, compare(f"{label} shadow", kbs, pbs))
                        checked.append({"scene": scene, "det": det, "mode": mode,
                                        "primary_hits": int(h.sum()),
                                        "shadow_hits": int(kbs.hit.sum()),
                                        "mean_steps": float(kb.steps.float().mean())})
            grids = {name: {"n_voxels": list(p.grid.meta.n_voxels), "nnz": p.grid.meta.nnz,
                            "occupied_cells": int((p.dda.cell_range[:, 1] > 0).sum()),
                            "mask_bytes": p.dda.occupancy.numel() * 4}
                     for name, p in (("serial", prep), ("parallel", pprep))}
            self.err["traverse_grid"] = max(self.err["traverse_grid"], err)
            emit({"phase": "kernel_B_vs_plain", "rays": rays.count, "grids": grids,
                  "cases": checked, "max_abs_err": err, "tolerance": "bitwise",
                  "equal": True})

    # ---- 5. kernel C vs its plain version --------------------------------
    def kernel_c(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.ops.persistent import persistent_trace, work_queue
        from ray_tracer_tpu_torch.render.renderer import prepare

        kC = self.kC
        cfg = apply_turbo(serial_scene_config(256, 256), "serial")
        preps = {"inline": prepare(cfg)}
        if not preps["inline"].packed.meta.inline:
            raise AssertionError("the turbo serial grid should take the inline layout")
        for name, change in (("blocks", dict(grid_layout="blocks")),
                             ("bt28", dict(packed_block_tris=28)),
                             ("bt56", dict(packed_block_tris=56))):
            preps[name] = prepare(dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, **change)))
        rcfg = cfg.render
        rays = camera_rays(cfg.camera, device=self.dev)
        light = preps["inline"].scene.light_pos
        fkw = dict(fused=True, shadow_gate=rcfg.shadow_eps, shadow_mint=rcfg.shadow_mint(),
                   serial_quirk=True, shade_serial=True)
        cases = [
            ("inline", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("inline", "fused", dict(fkw)),
            ("inline", "nearest", dict(t_gate=0.0)),
            ("inline", "any_hit", dict(t_gate=0.0, stop_on_first_hit=True)),
            ("blocks", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("blocks", "nearest", dict(t_gate=0.0)),
            ("blocks", "nearest_chain3", dict(t_gate=0.0, probe_chain=3)),
            ("bt28", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("bt28", "nearest", dict(t_gate=0.0)),
            ("bt56", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("bt56", "any_hit", dict(t_gate=0.0, stop_on_first_hit=True)),
        ]
        err = 0.0
        out = []
        capped = torch.zeros((1,), dtype=torch.int32, device=self.dev)
        for layout, name, kw in cases:
            p = preps[layout]
            grid, meta = p.packed.arrays, p.packed.meta
            plain = kC.march_plain(rays, grid, meta, light, capped_out=capped, **kw)
            if int(capped.item()):
                raise AssertionError(f"kernel C {layout} {name}: plain capped {int(capped)}")
            got = kC.march_cuda(rays, grid, meta, light, capped_out=capped, **kw)
            torch.cuda.synchronize()
            err = max(err, compare(f"kernel C {layout} {name}", got, plain))
            if int(capped.item()):
                raise AssertionError(f"kernel C {layout} {name}: {int(capped)} rays capped")
            out.append({"layout": layout, "case": name, "block_tris": meta.block_tris,
                        "inline": meta.inline,
                        "hits": int(plain.hit.sum()), "in_shadow": int(plain.in_shadow.sum()),
                        "mean_steps": float(plain.steps.float().mean()),
                        "max_steps": int(plain.steps.max())})
        # the queues of the persistent wave (compacted, chord-ordered),
        # directly and through persistent_trace
        p = preps["inline"]
        grid, meta = p.packed.arrays, p.packed.meta
        keys = kC.chord_keys(rays, grid)
        plain = kC.march_plain(rays, grid, meta, light, skip_dead_shadow=True, **fkw)
        for qname, qkw in (("compact", dict(compact=True)),
                           ("chord", dict(order_keys=keys)),
                           ("compact_chord", dict(compact=True, order_keys=keys))):
            ids, n_work = work_queue(rays, grid, compact=qkw.get("compact", False),
                                     order_keys=qkw.get("order_keys"))
            got = kC.march_cuda(rays, grid, meta, light, queue=ids, n_work=n_work,
                                skip_dead_shadow=True, capped_out=capped, **fkw)
            torch.cuda.synchronize()
            err = max(err, compare(f"kernel C {qname} queue", got, plain))
            if int(capped.item()):
                raise AssertionError(f"kernel C {qname} queue: rays capped")
            got = persistent_trace(
                rays, grid, meta, light, fuse_shadow=True, t_gate=0.0,
                shadow_gate=rcfg.shadow_eps, shadow_mint=rcfg.shadow_mint(),
                serial_quirk=True, shadow_skip_dead=True, shade_serial=True,
                need_t=True, need_steps=True, need_shadow_tri=True, capped_out=capped,
                **qkw)
            torch.cuda.synchronize()
            err = max(err, compare(f"kernel C persistent_trace {qname}", got, plain))
            if int(capped.item()):
                raise AssertionError(f"kernel C persistent_trace {qname}: rays capped")
        self.err["packed_march"] = max(self.err["packed_march"], err)
        emit({"phase": "kernel_C_vs_plain", "rays": rays.count,
              "grid": list(preps["inline"].packed.meta.n_voxels),
              "rows": {k: v.packed.meta.n_blocks for k, v in preps.items()},
              "cases": out, "queues": ["compact", "chord", "compact_chord"], "capped": 0,
              "max_abs_err": err, "tolerance": "bitwise", "equal": True})

    # ---- 6. kernel E vs its plain version --------------------------------
    def wave_inputs(self, cfg, prep):
        """Kernel E's arguments for a prepared wave config after the camera
        (the scene and grid tensors, the knobs of _render_whitted_wave) and
        the plain version's rays: the CPU camera batch, moved to the card,
        whose bits E's own rays must have."""
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.ops.camera import camera_rays

        rc = cfg.render
        mat9, tri9 = prep.wave
        rays = RayBatch(*(x.to(self.dev) for x in camera_rays(cfg.camera, spp=rc.spp,
                                                                device="cpu")))
        pg = rc.primary_gate()
        kw = dict(max_bounces=rc.max_bounces, serial=rc.serial_shading,
                  gate0=0.0 if pg is None else pg, gate_b=rc.bounce_gate(), eps=rc.shadow_eps,
                  smint=rc.shadow_mint(), quirk=rc.shadow_dir_away_from_light(),
                  shadow_scale=rc.shadow_scale, bg=tuple(rc.background))
        tail = (prep.scene.light_pos, prep.scene.light_intensity, mat9, tri9,
                prep.packed.arrays, prep.packed.meta)
        return tail, kw, rays

    def wave_launch(self, cfg, prep, tail, kw, **extra):
        """One launch of kernel E on a prepared wave config."""
        return self.kE.whitted_wave_cuda(cfg.camera, *tail, spp=cfg.render.spp, **kw,
                                         cam=prep.setup.cam, consts=prep.setup.consts,
                                         **extra)

    def check_rays(self, label, rays_out, rays):
        """E's own camera rays (orig, dirn, mint, maxt a row) against the CPU
        batch's bits."""
        want = torch.cat([rays.orig, rays.dirn, rays.mint[:, None], rays.maxt[:, None]], dim=1)
        bad = int((rays_out.view(torch.int32) != want.view(torch.int32)).sum())
        if bad:
            raise AssertionError(f"{label}: {bad} floats of kernel E's camera rays differ from "
                                 "the CPU batch")

    def wave_counters(self, prep, r):
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.dev)

        return dict(capped_out=z(1), passes_out=z(1), tested_out=z(r),
                    touched_out=z(prep.packed.meta.n_blocks),
                    slots_out=z(prep.packed.arrays.slot_tri.shape[0]),
                    events_out=z(len(self.kE.EVENTS)))

    def kernel_e(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, whitted_wave_eligible

        kE = self.kE

        def turbo(make, size, family, camera=None, **kw):
            cfg = apply_turbo(make(size, size), family)
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))
            if camera:
                cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, **camera))
            return cfg

        cases = [
            ("parallel_256", turbo(parallel_scene_config, 256, "parallel")),
            ("serial_256_on", turbo(serial_scene_config, 256, "serial", whitted_wave="on")),
            ("parallel_128_spp2", turbo(parallel_scene_config, 128, "parallel", spp=2)),
            ("parallel_128_spp2_dof", turbo(parallel_scene_config, 128, "parallel", spp=2,
                                            camera=dict(aperture=0.25, focus_distance=20.0))),
        ]
        err = 0.0
        out = []
        for name, cfg in cases:
            prep = prepare(cfg)
            if not whitted_wave_eligible(cfg, prep.scene):
                raise AssertionError(f"kernel E {name}: the config should take the wave")
            tail, kw, rays = self.wave_inputs(cfg, prep)
            r = rays.count
            cp = self.wave_counters(prep, r)
            want = kE.whitted_wave_plain(rays, *tail, **kw, **cp)
            ck = self.wave_counters(prep, r)
            ro = torch.empty((r, 8), dtype=torch.float32, device=self.dev)
            lanes = torch.zeros((2,), dtype=torch.int64, device=self.dev)
            got = self.wave_launch(cfg, prep, tail, kw, rays_out=ro, lanes_out=lanes, **ck)
            torch.cuda.synchronize()
            label = f"kernel E {name}"
            self.check_rays(label, ro, rays)
            err = max(err, compare(label, (got.reshape(-1),), (want.reshape(-1),)))
            for key in ck:
                if not torch.equal(ck[key], cp[key]):
                    raise AssertionError(f"{label}: counter {key} differs from the plain "
                                         "version's")
            if int(ck["capped_out"].item()):
                raise AssertionError(f"{label}: {int(ck['capped_out'])} lanes capped")
            it, steps = lanes.tolist()
            out.append({"case": name, "positions": r, "spp": cfg.render.spp,
                        "aperture": cfg.camera.aperture, "serial": cfg.render.serial_shading,
                        "events": dict(zip(kE.EVENTS, ck["events_out"].tolist())),
                        "rows_tested": int(ck["tested_out"].sum()),
                        "passes": int(ck["passes_out"].item()), "capped": 0,
                        "rays_equal": True, "lane_utilisation": steps / (32 * it)})
        self.err["whitted_wave"] = max(self.err["whitted_wave"], err)
        emit({"phase": "kernel_E_vs_plain", "cases": out, "max_abs_err": err,
              "tolerance": "bitwise (colors, every counter and E's camera rays)",
              "equal": True})

    # ---- 10. kernel F vs its plain version --------------------------------
    def gi_config(self, make, size, family, S, D, height=None, **kw):
        """A path-traced turbo config (gi_samples set before apply_turbo, as
        the command line sets it), size x size or size x height pixels."""
        from ray_tracer_tpu_torch.config import apply_turbo

        cfg = make(size, height or size)
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, gi_samples=S))
        cfg = apply_turbo(cfg, family)
        return dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, gi_samples=S, gi_depth=D, **kw))

    def gi_inputs(self, prep):
        """Kernel F's arguments for a prepared GI wave config after the
        camera, and the plain version's rays (the CPU camera batch on the
        card)."""
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.ops.camera import camera_rays

        tail, kw = self.kF.launch_inputs(prep)
        rays = RayBatch(*(x.to(self.dev) for x in camera_rays(prep.cfg.camera, device="cpu")))
        return tail, kw, rays

    def gi_launch(self, prep, tail, kw, **extra):
        """One launch of kernel F on a prepared GI wave config."""
        return self.kF.gi_wave_cuda(prep.cfg.camera, *tail, **kw, cam=prep.setup.cam,
                                    consts=prep.setup.consts, **extra)

    def gi_counters(self):
        return dict(capped_out=torch.zeros((1,), dtype=torch.int32, device=self.dev),
                    passes_out=torch.zeros((1,), dtype=torch.int32, device=self.dev),
                    events_out=torch.zeros((len(self.kF.EVENTS),), dtype=torch.int64,
                                           device=self.dev))

    def gi_check(self, label, prep):
        """F against its plain version on prep's frame: radiance bitwise,
        every counter equal, no pixel capped.  Returns (max |err|, events,
        passes)."""
        tail, kw, rays = self.gi_inputs(prep)
        cp, ck = self.gi_counters(), self.gi_counters()
        want = self.kF.gi_wave_plain(rays, *tail, **kw, **cp)
        got = self.gi_launch(prep, tail, kw, **ck)
        torch.cuda.synchronize()
        err = compare(label, (got.reshape(-1),), (want.reshape(-1),))
        for key in ck:
            if not torch.equal(ck[key], cp[key]):
                raise AssertionError(f"{label}: counter {key} differs from the plain "
                                     f"version's: {ck[key].tolist()} vs {cp[key].tolist()}")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"{label}: {int(ck['capped_out'])} pixels capped")
        return err, dict(zip(self.kF.EVENTS, ck["events_out"].tolist())), int(ck["passes_out"])

    def plane_gi_config(self, size):
        """The escape-only plane (tests/test_torch_gi_wave.py): every bounce
        escapes to the background, so radiance is direction-independent."""
        from ray_tracer_tpu_torch.config import (CameraConfig, LightConfig, MaterialConfig,
                                                 SceneConfig)
        from ray_tracer_tpu_torch.models import meshes
        from ray_tracer_tpu_torch.models.scenes import scene_from_meshes

        mats = (MaterialConfig(base_color=(140.0, 90.0, 200.0)),)
        light = LightConfig(position=(0.5, 6.0, 0.3), intensity=60.0)
        scene = scene_from_meshes([(meshes.make_plane(extent=8.0, y=-1.0, density=2), 0)],
                                  mats, light, device=self.dev)
        cfg = SceneConfig(materials=mats, light=light, camera=CameraConfig(
            position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=size, height=size))
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, det_dtype="float32", traversal="packed",
            scheduler="persistent", gi_samples=3, gi_depth=2, background=(30.0, 20.0, 10.0),
            gi_wave="on"))
        return cfg, scene

    def kernel_f(self):
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare

        plane_cfg, plane_scene = self.plane_gi_config(64)
        cases = [
            ("serial_128_s4d2", self.gi_config(serial_scene_config, 128, "serial", 4, 2), None),
            ("parallel_128_s2d3", self.gi_config(parallel_scene_config, 128, "parallel", 2, 3),
             None),
            ("escape_plane_64_s3d2", plane_cfg, plane_scene),
            ("serial_128_s4d0", self.gi_config(serial_scene_config, 128, "serial", 4, 0), None),
            # 7,500 pixels: no multiple of 32 or of a chunk (the queues' tails)
            ("serial_100x75_s3d2", self.gi_config(serial_scene_config, 100, "serial", 3, 2,
                                                  height=75), None),
            # eight items a queued pixel (the fold's order)
            ("serial_128_s8d1", self.gi_config(serial_scene_config, 128, "serial", 8, 1), None),
        ]
        err = 0.0
        out = []
        for name, cfg, scene in cases:
            prep = prepare(cfg, scene=scene)
            if not prep.setup.gi_wave:
                raise AssertionError(f"kernel F {name}: the config should take the GI wave")
            e, events, passes = self.gi_check(f"kernel F {name}", prep)
            err = max(err, e)
            out.append({"case": name, "pixels": cfg.camera.width * cfg.camera.height,
                        "S": cfg.render.gi_samples, "D": cfg.render.gi_depth,
                        "mirror_mix": prep.gi.km is not None, "events": events,
                        "passes": passes, "capped": 0})
        self.err["gi_wave"] = max(self.err["gi_wave"], err)
        emit({"phase": "kernel_F_vs_plain", "cases": out, "max_abs_err": err,
              "tolerance": "bitwise (radiance and every counter)", "equal": True})

    # ---- 7. (continued) the path-traced render and the nefertiti scene --
    def main_gi(self):
        """The official GI row (turbo serial 1024x1024, S = 4, D = 2) through
        prepare + render: one launch of F a frame and nothing else."""
        from ray_tracer_tpu_torch.core import vecmath as vm
        from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        size, S, D = 1024, 4, 2
        cfg = self.gi_config(serial_scene_config, size, "serial", S, D)
        t0 = time.perf_counter()
        p = prepare(cfg)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        self.zero_counts()
        img = render(p)
        torch.cuda.synchronize()
        counts = self.counts()
        if counts["gi_wave"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"the GI frame launched {counts}: F once and nothing else "
                                 "expected")
        self.launches["gi_wave"] = counts["gi_wave"]
        if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"GI render: bad image {tuple(img.shape)}")
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img = render(p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = sorted(secs)[2]
        gi_u8 = tonemap_u8(img.cpu().numpy())
        # F's counters on this frame's inputs (a separate, counted launch)
        tail, kw, _ = self.gi_inputs(p)
        ck = self.gi_counters()
        counted = self.gi_launch(p, tail, kw, **ck)
        torch.cuda.synchronize()
        if not torch.equal(vm.div_scalar(counted, float(S)).view(torch.int32),
                           img.reshape(-1, 3).view(torch.int32)):
            raise AssertionError("the counted launch of kernel F differs from the frame")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"GI frame: {int(ck['capped_out'])} pixels capped")
        events = dict(zip(self.kF.EVENTS, ck["events_out"].tolist()))
        segments = events["primaries"] + events["bounce_segments"] + events["shadow_rays"]
        self.gi_frame = p
        emit({"phase": "main_path", "config": "turbo_spot_gi_s4d2", "size": size,
              "S": S, "D": D, "pump": cfg.render.pump, "triangles": p.scene.num_faces,
              "prepare_s": prep_s, "median_ms": med * 1e3,
              "renders_ms": [x * 1e3 for x in secs],
              "mpaths_per_s": size * size * S / med / 1e6,
              "segments_marched": segments, "segments_marched_per_s_of_frame": segments / med,
              "bench_py_gi_mrays_per_s": size * size * S * 2 * (D + 1) / med / 1e6,
              "sync_debug_mode": "error", "events": events, "launches_per_frame": counts,
              "lit_pixels": int((gi_u8.max(axis=-1) > 0).sum()),
              "packed_grid": {"n_voxels": list(p.packed.meta.n_voxels),
                              "rows": p.packed.meta.n_blocks, "inline": p.packed.meta.inline,
                              "block_tris": p.packed.meta.block_tris}})
        prof = profile_render(p, med, "turbo_spot_gi_s4d2")
        self.path_launches["turbo_spot_gi_s4d2"] = dict(
            counts, cuda_kernels_per_frame=prof["kernels_per_frame"])
        emit(prof)

        out_ppm = os.path.join(self.root, "build", "chip_smoke_cli_gi.ppm")
        os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
        cli = subprocess.run(
            [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "serial",
             "--width", str(size), "--turbo", "--gi", str(S), "--gi-depth", str(D),
             "--out", out_ppm],
            cwd=self.root, capture_output=True, text=True, timeout=600,
        )
        if cli.returncode != 0:
            raise AssertionError(f"cli render gi failed:\n{cli.stderr[-3000:]}")
        if not (read_ppm(out_ppm) == gi_u8).all():
            raise AssertionError("cli render gi differs from the in-process render")
        emit({"phase": "cli", "config": "turbo_spot_gi_s4d2", "size": size,
              "same_bytes_as_render": True, "stderr": cli.stderr.strip().splitlines()[-1]})

    def gi_wave_vs_segments(self):
        """The GI wave (F) against the segment integrator (C, one fused march
        a sample batch and depth) at 256x256: the JAX package's rule for its
        own wave (tests/test_pathtrace.py:565-586), more than 97% of pixels
        within 1e-5 and the means within 2%.  Each of the segment
        integrator's launches of C is held to the plain version at its own
        inputs."""
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        for name, cfg in (("serial_s4d2", self.gi_config(serial_scene_config, 256, "serial",
                                                         4, 2)),
                          ("parallel_s2d3", self.gi_config(parallel_scene_config, 256,
                                                           "parallel", 2, 3))):
            p = prepare(cfg)
            self.zero_counts()
            wave = render(p)
            torch.cuda.synchronize()
            wcounts = self.counts()
            off = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                      gi_wave="off"))
            self.zero_counts()
            with self.logging_launches() as log:
                seg = render(p._replace(cfg=off))
                torch.cuda.synchronize()
            scounts = self.counts()
            self.path_launches[f"gi_wave_{name}_256"] = wcounts
            self.path_launches[f"gi_segments_{name}_256"] = scounts
            if wcounts["gi_wave"] != 1 or scounts["gi_wave"] or scounts["packed_march"] <= 0:
                raise AssertionError(f"GI {name}: wave launched {wcounts}, segments {scounts}")
            held = self.hold_logged(f"GI segments {name}", log)
            same = float(((wave - seg).abs() <= 1e-5).all(dim=-1).float().mean())
            means = (float(wave.mean()), float(seg.mean()))
            rel = abs(means[0] - means[1]) / max(abs(means[1]), 1e-30)
            emit({"phase": "gi_wave_vs_segments", "case": name, "size": 256,
                  "pixels_within_1e-5": same, "means": means, "means_rel_diff": rel,
                  "bitwise_pixels": float((wave.view(torch.int32) == seg.view(torch.int32))
                                          .all(dim=-1).float().mean()),
                  "segment_launches": scounts, "segments_kernel_C_held": held})
            if same <= 0.97 or rel > 0.02:
                raise AssertionError(f"GI wave vs segments {name}: {same:.4f} of pixels within "
                                     f"1e-5, means {means}")

    def main_nefertiti(self):
        """The turbo nefertiti scene (261,120 faces) at 1024x1024: kernel C
        with the tuned knobs, each of its launches held to the plain version
        at the frame's own inputs, and its image against the csr image
        (kernel B) by the 2-count rule."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        size = 1024
        scene, base = nefertiti_scene(size, size, device=self.dev)
        imgs = {}
        for name, cfg, kernel in (
                ("turbo_nefertiti", apply_turbo(base, "nefertiti"), "packed_march"),
                ("csr_nefertiti", dataclasses.replace(base, render=dataclasses.replace(
                    base.render, traversal="csr")), "traverse_grid")):
            t0 = time.perf_counter()
            p = prepare(cfg, scene=scene)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            self.zero_counts()
            with self.logging_launches() as log:
                img = render(p)
                torch.cuda.synchronize()
            counts = self.counts()
            self.path_launches[name] = counts
            if counts[kernel] <= 0:
                raise AssertionError(f"{name} launched {kernel} 0 times")
            if name == "turbo_nefertiti":
                self.nef_prep = p  # the train phase fits this prepared scene
                held = self.hold_logged(name, log)
                emit({"phase": "kernel_C_on_path", "config": name, "size": size,
                      "layout": "inline" if p.packed.meta.inline else "blocks",
                      "held": held, "tolerance": "bitwise (records, rows tested and "
                      "touched, capped lanes, most steps)", "equal": True})
            if not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name}: non-finite pixels")
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                img = render(p)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            med = sorted(secs)[2]
            imgs[name] = tonemap_u8(img.cpu().numpy())
            line = {"phase": "main_path", "config": name, "size": size,
                    "triangles": p.scene.num_faces, "prepare_s": prep_s,
                    "median_ms": med * 1e3, "renders_ms": [x * 1e3 for x in secs],
                    "mrays_per_s": size * size * 2 / med / 1e6, "launches_per_frame": counts,
                    "lit_pixels": int((imgs[name].max(axis=-1) > 0).sum())}
            if p.packed is not None:
                line["packed_grid"] = {"n_voxels": list(p.packed.meta.n_voxels),
                                       "rows": p.packed.meta.n_blocks,
                                       "inline": p.packed.meta.inline,
                                       "block_tris": p.packed.meta.block_tris,
                                       "max_blocks": p.packed.meta.max_blocks}
            emit(line)
            if name == "turbo_nefertiti":
                emit(profile_render(p, med, name))
        frac = image_rule(imgs["turbo_nefertiti"], imgs["csr_nefertiti"])
        emit({"phase": "nefertiti_agreement", "pixels_over_2_counts": frac,
              "bytes_differing": int((imgs["turbo_nefertiti"] != imgs["csr_nefertiti"]).sum())})
        if frac >= 0.01:
            raise AssertionError(f"nefertiti turbo vs csr: {frac:.2%} of pixels differ by > 2")

    # ---- 7. the main path at full size -----------------------------------
    def main_path(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        size = 1024
        main_cfg = serial_scene_config(size, size)
        configs = {
            "csr": (main_cfg, "traverse_grid"),
            "brute_pallas": (dataclasses.replace(main_cfg, render=dataclasses.replace(
                main_cfg.render, traversal="brute_pallas", faithful=False)), "brute_intersect"),
            "turbo": (apply_turbo(main_cfg, "serial"), "packed_march"),
        }
        for name, (cfg, kernel) in configs.items():
            t0 = time.perf_counter()
            p = prepare(cfg)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            self.zero_counts()
            img = render(p)
            torch.cuda.synchronize()
            counts = self.counts()
            if counts[kernel] <= 0:
                raise AssertionError(f"render with config {name} launched {kernel} 0 times")
            self.launches[kernel] = counts[kernel]
            self.path_launches[name] = counts
            if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name} render: bad image {tuple(img.shape)}")
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                img = render(p)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            med = sorted(secs)[2]
            self.images[name] = tonemap_u8(img.cpu().numpy())
            line = {"phase": "main_path", "config": name, "size": size,
                    "prepare_s": prep_s, "median_ms": med * 1e3,
                    "renders_ms": [s * 1e3 for s in secs],
                    "mrays_per_s": size * size * 2 / med / 1e6,
                    "launches_per_frame": counts,
                    "lit_pixels": int((self.images[name].max(axis=-1) > 0).sum())}
            if name == "turbo":
                line["packed_grid"] = {"n_voxels": list(p.packed.meta.n_voxels),
                                       "rows": p.packed.meta.n_blocks,
                                       "inline": p.packed.meta.inline,
                                       "max_blocks": p.packed.meta.max_blocks,
                                       "table_mb": p.packed.arrays.blocks.numel() * 4 / 1e6}
            emit(line)
            if name in ("csr", "turbo"):
                emit(profile_render(p, med, name))
        agree = {}
        for name in ("brute_pallas", "turbo"):
            frac = image_rule(self.images["csr"], self.images[name])
            if frac >= 0.01:
                raise AssertionError(f"csr vs {name}: {frac:.2%} of pixels differ by > 2")
            agree[name] = frac
        emit({"phase": "main_path_agreement", "pixels_over_2_counts": agree["brute_pallas"],
              "turbo_pixels_over_2_counts": agree["turbo"],
              "turbo_bytes_differing_from_csr": int(
                  (self.images["csr"] != self.images["turbo"]).sum())})

        # the default and the --turbo renders through the command line
        for name, extra in (("csr", []), ("turbo", ["--turbo"])):
            out_ppm = os.path.join(self.root, "build", f"chip_smoke_cli_{name}.ppm")
            os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
            cli = subprocess.run(
                [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene",
                 "serial", "--width", str(size), "--out", out_ppm, *extra],
                cwd=self.root, capture_output=True, text=True, timeout=600,
            )
            if cli.returncode != 0:
                raise AssertionError(f"cli render {name} failed:\n{cli.stderr[-3000:]}")
            if not (read_ppm(out_ppm) == self.images[name]).all():
                raise AssertionError(f"cli render {name} differs from the in-process render")
            emit({"phase": "cli", "config": name, "size": size, "same_bytes_as_render": True,
                  "stderr": cli.stderr.strip().splitlines()[-1]})

        self.main_wave()
        self.main_gi()
        self.gi_wave_vs_segments()
        self.main_nefertiti()

        base = parallel_scene_config(512, 512)
        turbo = apply_turbo(base, "parallel")
        turbo = dataclasses.replace(turbo, render=dataclasses.replace(
            turbo.render, whitted_wave="off"))
        for name, pcfg, kernel in (("csr", base, "traverse_grid"),
                                   ("turbo", turbo, "packed_march")):
            pp = prepare(pcfg)
            self.zero_counts()
            render(pp)
            torch.cuda.synchronize()
            pcounts = self.counts()
            self.path_launches[f"parallel_512_{name}"] = pcounts
            if pcounts[kernel] <= 0:
                raise AssertionError(f"parallel render {name} launched {kernel} 0 times")
            t0 = time.perf_counter()
            pimg = render(pp)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(pimg).all()):
                raise AssertionError(f"parallel render {name}: non-finite pixels")
            self.images["parallel_" + name] = tonemap_u8(pimg.cpu().numpy())
            emit({"phase": "parallel_scene", "config": name, "size": 512,
                  "triangles": pp.scene.num_faces, "bounces": pcfg.render.max_bounces,
                  "ms": pms, "launches_per_frame": pcounts})
        frac = image_rule(self.images["parallel_csr"], self.images["parallel_turbo"])
        emit({"phase": "parallel_agreement", "pixels_over_2_counts": frac})
        if frac >= 0.01:
            raise AssertionError(f"parallel csr vs turbo: {frac:.2%} of pixels differ by > 2")
        # each main-path render's own launches, counted from 0 (the
        # `kernels` line gives each kernel's count on its first path:
        # B csr, A brute_pallas, C turbo, E turbo_parallel_wave, F the GI row)
        emit({"phase": "launches_by_path", "paths": self.path_launches})

    def main_wave(self):
        """The turbo parallel scene at 1024x1024 through prepare + render: the
        cross-depth Whitted wave, one launch of kernel E a frame and none of
        C; against the bounce loop (whitted_wave="off", four launches of C)
        and through the command line."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        kE = self.kE
        size = 1024
        cfg = apply_turbo(parallel_scene_config(size, size), "parallel")
        t0 = time.perf_counter()
        p = prepare(cfg)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        self.zero_counts()
        img = render(p)
        torch.cuda.synchronize()
        counts = self.counts()
        if counts["whitted_wave"] != 1 or counts["packed_march"] != 0:
            raise AssertionError(f"the turbo parallel frame launched {counts}: E once and C "
                                 "never expected")
        self.launches["whitted_wave"] = counts["whitted_wave"]
        self.path_launches["turbo_parallel_wave"] = counts
        if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"turbo parallel render: bad image {tuple(img.shape)}")
        # each frame under the sync debug mode: a device-to-host copy or a
        # synchronisation inside render raises
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img = render(p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = sorted(secs)[2]
        wave_u8 = tonemap_u8(img.cpu().numpy())
        # E's counters and camera rays on this frame's inputs (a separate,
        # counted launch)
        tail, kw, rays = self.wave_inputs(cfg, p)
        ck = self.wave_counters(p, rays.count)
        ro = torch.empty((rays.count, 8), dtype=torch.float32, device=self.dev)
        counted = self.wave_launch(cfg, p, tail, kw, rays_out=ro, **ck)
        torch.cuda.synchronize()
        self.check_rays("kernel E 1024", ro, rays)
        if not torch.equal(counted.view(torch.int32), img.reshape(-1, 3).view(torch.int32)):
            raise AssertionError("the counted launch of kernel E differs from the frame")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"turbo parallel frame: {int(ck['capped_out'])} lanes capped")
        events = dict(zip(kE.EVENTS, ck["events_out"].tolist()))
        segments = events["primaries"] + events["shadow_rays"] + events["mirror_rays"]
        self.wave_frame = (cfg, p)
        emit({"phase": "main_path", "config": "turbo_parallel_wave", "size": size,
              "triangles": p.scene.num_faces, "bounces": cfg.render.max_bounces,
              "prepare_s": prep_s, "median_ms": med * 1e3, "renders_ms": [x * 1e3 for x in secs],
              "pixels_per_s_of_frame": size * size / med,
              "segments_marched": segments,
              "segments_marched_per_s_of_frame": segments / med,
              "sync_debug_mode": "error", "rays_equal_cpu_batch": True,
              "events": events, "launches_per_frame": counts,
              "packed_grid": {"n_voxels": list(p.packed.meta.n_voxels),
                              "rows": p.packed.meta.n_blocks, "inline": p.packed.meta.inline,
                              "block_tris": p.packed.meta.block_tris,
                              "max_blocks": p.packed.meta.max_blocks,
                              "table_mb": p.packed.arrays.blocks.numel() * 4 / 1e6}})
        emit(profile_render(p, med, "turbo_parallel_wave"))

        off = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                  whitted_wave="off"))
        self.zero_counts()
        loop = render(p._replace(cfg=off))
        torch.cuda.synchronize()
        lcounts = self.counts()
        self.path_launches["turbo_parallel_bounce_loop"] = lcounts
        if lcounts["packed_march"] != cfg.render.max_bounces + 1 or lcounts["whitted_wave"]:
            raise AssertionError(f"the bounce-loop frame launched {lcounts}")
        frac = image_rule(wave_u8, tonemap_u8(loop.cpu().numpy()))
        big = torch.maximum(img.abs(), loop.abs())
        rel = float(torch.where(big > 0, (img - loop).abs() / big,
                                torch.zeros_like(big)).max())
        emit({"phase": "wave_vs_bounce_loop", "size": size, "pixels_over_2_counts": frac,
              "bytes_differing": int((wave_u8 != tonemap_u8(loop.cpu().numpy())).sum()),
              "max_rel_diff": rel, "max_abs_diff": float((img - loop).abs().max()),
              "bounce_loop_launches": lcounts})
        if frac >= 0.01:
            raise AssertionError(f"wave vs bounce loop: {frac:.2%} of pixels differ by > 2")

        out_ppm = os.path.join(self.root, "build", "chip_smoke_cli_parallel.ppm")
        os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
        cli = subprocess.run(
            [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "parallel",
             "--width", str(size), "--turbo", "--out", out_ppm],
            cwd=self.root, capture_output=True, text=True, timeout=600,
        )
        if cli.returncode != 0:
            raise AssertionError(f"cli render parallel failed:\n{cli.stderr[-3000:]}")
        if not (read_ppm(out_ppm) == wave_u8).all():
            raise AssertionError("cli render parallel differs from the in-process render")
        emit({"phase": "cli", "config": "turbo_parallel_wave", "size": size,
              "same_bytes_as_render": True, "stderr": cli.stderr.strip().splitlines()[-1]})

    # ---- 8. card vs CPU --------------------------------------------------
    def card_vs_cpu(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.ops.persistent import persistent_trace
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        small = serial_scene_config(64, 64)
        small = dataclasses.replace(small, render=dataclasses.replace(
            small.render, det_dtype="float64"))
        on_card = tonemap_u8(render(prepare(small)).cpu().numpy())
        on_cpu = tonemap_u8(render(prepare(small, device="cpu")).numpy())
        n_bad = int((on_card != on_cpu).sum())
        if n_bad:
            raise AssertionError(f"64x64 float64 render: {n_bad} PPM bytes differ card vs CPU")
        emit({"phase": "card_vs_cpu", "size": 64, "det_dtype": "float64", "bytes_differing": 0})

        cfg = apply_turbo(serial_scene_config(64, 64), "serial")
        rcfg = cfg.render
        recs = {}
        imgs = {}
        for dev in ("cuda", "cpu"):
            p = prepare(cfg, device=dev)
            rays = camera_rays(cfg.camera, device=dev)
            recs[dev] = persistent_trace(
                rays, p.packed.arrays, p.packed.meta, p.scene.light_pos, wave=rcfg.wave,
                fuse_shadow=True, t_gate=0.0, shadow_gate=rcfg.shadow_eps,
                shadow_mint=rcfg.shadow_mint(), serial_quirk=True, shadow_skip_dead=True,
                shade_serial=True, need_t=True, need_steps=True, need_shadow_tri=True)
            imgs[dev] = tonemap_u8(render(p).cpu().numpy())
        compare("turbo 64 card vs CPU records", tuple(x.cpu() for x in recs["cuda"]),
                tuple(recs["cpu"]))
        frac = image_rule(imgs["cuda"], imgs["cpu"])
        if frac >= 0.01:
            raise AssertionError(f"turbo 64 card vs CPU: {frac:.2%} of pixels differ by > 2")
        emit({"phase": "card_vs_cpu", "size": 64, "config": "turbo", "records_equal": True,
              "hits": int(recs["cpu"].hit.sum()),
              "bytes_differing": int((imgs["cuda"] != imgs["cpu"]).sum()),
              "pixels_over_2_counts": frac})

        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config

        wcfg = apply_turbo(parallel_scene_config(64, 64), "parallel")
        wprep = prepare(wcfg)
        self.zero_counts()
        w_card = render(wprep)
        torch.cuda.synchronize()
        if self.counts()["whitted_wave"] != 1:
            raise AssertionError("the 64x64 turbo parallel render did not launch kernel E")
        w_cpu = render(prepare(wcfg, device="cpu"))
        a, b = tonemap_u8(w_card.cpu().numpy()), tonemap_u8(w_cpu.numpy())
        frac = image_rule(a, b)
        if frac >= 0.01:
            raise AssertionError(f"wave 64 card vs CPU: {frac:.2%} of pixels differ by > 2")
        diff = (w_card.cpu().view(torch.int32) != w_cpu.view(torch.int32)).any(dim=-1)
        # the torch CUDA camera batch (what the wave traced before kernel E
        # made its own rays) against the CPU batch
        cam_card = camera_rays(wcfg.camera, device=self.dev)
        cam_cpu = camera_rays(wcfg.camera, device="cpu")
        cam_bad = sum(int((x.cpu().view(torch.int32) != y.view(torch.int32)).sum())
                      for x, y in zip(cam_card[:2], cam_cpu[:2]))
        line = {"phase": "card_vs_cpu", "size": 64, "config": "turbo_parallel_wave",
                "bytes_differing": int((a != b).sum()), "pixels_over_2_counts": frac,
                "floats_differing": int((w_card.cpu().view(torch.int32)
                                         != w_cpu.view(torch.int32)).sum()),
                "pixels_differing": int(diff.sum()),
                "cuda_camera_batch_floats_differing": cam_bad}
        if bool(diff.any()):
            line["pow"] = self.wave_pow_probe(wcfg, wprep, diff.reshape(-1).nonzero()[:, 0])
        emit(line)

        # path-traced GI at 64x64 through the GI wave (F on the card, its
        # plain version on the CPU): cos and sin are taken in float64 on
        # both, so the radiance is held bitwise
        for name, gcfg in (("turbo_spot_gi_s4d2",
                            self.gi_config(serial_scene_config, 64, "serial", 4, 2)),
                           ("turbo_parallel_gi_s2d3",
                            self.gi_config(parallel_scene_config, 64, "parallel", 2, 3))):
            self.zero_counts()
            g_card = render(prepare(gcfg))
            torch.cuda.synchronize()
            if self.counts()["gi_wave"] != 1:
                raise AssertionError(f"the 64x64 {name} render did not launch kernel F")
            g_cpu = render(prepare(gcfg, device="cpu"))
            n_bad = int((g_card.cpu().view(torch.int32) != g_cpu.view(torch.int32)).sum())
            emit({"phase": "card_vs_cpu", "size": 64, "config": name,
                  "tolerance": "bitwise (cos and sin in float64 on both)",
                  "floats_differing": n_bad,
                  "max_abs_diff": float((g_card.cpu() - g_cpu).abs().max())})
            if n_bad:
                raise AssertionError(f"GI 64 {name}: {n_bad} floats differ card vs CPU")

        # the segment integrator over the csr grid (kernel B), the command
        # line's GI without --turbo: each launch of B held to the plain
        # version, and the image against the CPU's by the 2-count rule
        ccfg = serial_scene_config(64, 64)
        ccfg = dataclasses.replace(ccfg, render=dataclasses.replace(
            ccfg.render, faithful=False, gi_samples=2, gi_depth=1))
        cprep = prepare(ccfg)
        self.zero_counts()
        with self.logging_launches() as log:
            c_card = render(cprep)
            torch.cuda.synchronize()
        ccounts = self.counts()
        if ccounts["traverse_grid"] <= 0 or ccounts["packed_march"] or ccounts["gi_wave"]:
            raise AssertionError(f"the 64x64 csr GI render launched {ccounts}: B only expected")
        held = self.hold_logged("csr GI 64", log)
        c_cpu = render(prepare(ccfg, device="cpu"))
        a, b = tonemap_u8(c_card.cpu().numpy()), tonemap_u8(c_cpu.numpy())
        frac = image_rule(a, b)
        emit({"phase": "card_vs_cpu", "size": 64, "config": "csr_spot_gi_s2d1",
              "launches": ccounts, "kernel_B_held": held,
              "tolerance": "launches of B bitwise; image by the 2-count rule",
              "floats_differing": int((c_card.cpu().view(torch.int32)
                                       != c_cpu.view(torch.int32)).sum()),
              "bytes_differing": int((a != b).sum()), "pixels_over_2_counts": frac})
        if frac >= 0.01:
            raise AssertionError(f"csr GI 64 card vs CPU: {frac:.2%} of pixels differ by > 2")

    # ---- 11. the appearance epilogues ------------------------------------
    def appearance_images(self):
        """The full-width renders' image texture (256 x 256 x 3, in [0, 1])
        and environment map (256 x 512 x 3, color units), made in numpy from
        a fixed seed: gradients with noise, on the card."""
        import numpy as np

        rng = np.random.default_rng(20261017)
        yy, xx = np.meshgrid(np.linspace(0.0, 1.0, 256), np.linspace(0.0, 1.0, 256),
                             indexing="ij")
        tex = np.stack([xx, yy, 1.0 - xx * yy], axis=-1) * 0.7 + 0.3 * rng.random((256, 256, 3))
        pol, azi = np.meshgrid(np.linspace(0.0, 1.0, 256), np.linspace(0.0, 1.0, 512),
                               indexing="ij")
        sky = np.stack([60.0 + 150.0 * (1.0 - pol), 90.0 + 120.0 * (1.0 - pol),
                        120.0 + 60.0 * np.cos(2.0 * np.pi * azi)], axis=-1)
        env = sky + 40.0 * rng.random((256, 512, 3))
        return (torch.from_numpy(tex.astype(np.float32)).to(self.dev),
                torch.from_numpy(env.astype(np.float32)).to(self.dev))

    def quad_gi_config(self, size, S, D, texture, **kw):
        """The uv-mapped quad under a point light (tests/test_torch_appearance.py,
        after tests/test_pathtrace.py's textured scene), prepared for the GI
        wave: (cfg, scene)."""
        import numpy as np

        from ray_tracer_tpu_torch.config import (CameraConfig, LightConfig, MaterialConfig,
                                                 SceneConfig)
        from ray_tracer_tpu_torch.io.obj import MeshArrays
        from ray_tracer_tpu_torch.models.scenes import scene_from_meshes

        quad = MeshArrays(
            verts=np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
            faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
            uv_faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32))
        mat = MaterialConfig(base_color=(200.0, 120.0, 60.0), kd=2.0, ks=0.0, spec_alpha=4.0,
                             ka=0.3, **kw.pop("material", {}))
        light = LightConfig(position=(0.0, 8.0, 0.0), intensity=50.0)
        scene = scene_from_meshes([(quad, 0)], [mat], light, device=self.dev)
        cfg = SceneConfig(materials=(mat,), light=light, camera=CameraConfig(
            position=(0.0, 5.0, 0.01), target=(0, 0, 0), up=(0, 0, 1), fov_degrees=45.0,
            width=size, height=size))
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, shading="parallel", faithful=False, det_dtype="float32",
            traversal="packed", scheduler="persistent", shadow_eps=1e-3, texture=texture,
            texture_scale=4.0, gi_samples=S, gi_depth=D, gi_wave="on", **kw))
        return cfg, scene

    def appearance_cases(self):
        """Kernel F's feature cases, 64^2 to 128^2, after the JAX package's
        tests (tests/test_pathtrace.py:695-1000): (name, cfg, scene)."""
        import numpy as np

        from ray_tracer_tpu_torch.models.scenes import (build_scene, gradcheck_scene,
                                                        parallel_scene_config)

        def rep(cfg, **kw):
            return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))

        def img(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.dev)

        flat = img(np.broadcast_to(np.float32(100.0), (4, 8, 3)))
        ramp = img(np.linspace(5.0, 90.0, 4 * 8 * 3).reshape(4, 8, 3))
        tex = img(np.linspace(0.1, 1.0, 4 * 4 * 3).reshape(4, 4, 3))
        cases = []
        plane_cfg, plane_scene = self.plane_gi_config(64)
        furnace = plane_scene._replace(
            env_image=flat, materials=plane_scene.materials._replace(
                base_color=torch.full_like(plane_scene.materials.base_color, 127.5)),
            light_intensity=torch.zeros_like(plane_scene.light_intensity))
        cases.append(("env_furnace_plane_64_s3d1", rep(plane_cfg, gi_samples=3, gi_depth=1),
                      furnace))
        gscene, gcfg = gradcheck_scene(128, 128, device=self.dev)
        gscene = gscene._replace(light_intensity=torch.full_like(gscene.light_intensity, 40.0))
        gcfg = rep(gcfg, faithful=False, det_dtype="float32", traversal="packed",
                   scheduler="persistent", gi_wave="on")
        cases.append(("env_gradcheck_128_s2d2", rep(gcfg, gi_samples=2, gi_depth=2),
                      gscene._replace(env_image=ramp)))
        cases.append(("smooth_plane_64_s2d1",
                      rep(plane_cfg, gi_samples=2, gi_depth=1, normal_mode="smooth"),
                      plane_scene))
        cases.append(("smooth_gradcheck_128_s2d1",
                      rep(gcfg, gi_samples=2, gi_depth=1, normal_mode="smooth"), gscene))
        for texture in ("checker", "image"):
            for D in (0, 1):
                cfg, scene = self.quad_gi_config(64, 2, D, texture,
                                                 background=(12.0, 8.0, 4.0))
                if texture == "image":
                    scene = scene._replace(texture_image=tex)
                cases.append((f"{texture}_quad_64_s2d{D}", cfg, scene))
        cfg, scene = self.quad_gi_config(64, 2, 0, "checker", normal_mode="smooth",
                                         material=dict(km=0.3, reflective=True))
        cases.append(("all_quad_mirror_64_s2d0", cfg, scene._replace(
            env_image=img(np.broadcast_to(np.array([40.0, 30.0, 20.0], np.float32),
                                          (4, 8, 3))))))
        pcfg = rep(self.gi_config(parallel_scene_config, 128, "parallel", 2, 3),
                   normal_mode="smooth", texture="image", gi_wave="on")
        cases.append(("all_parallel_mirror_128_s2d3", pcfg, build_scene(pcfg)._replace(
            env_image=ramp, texture_image=tex)))
        return cases

    # ---- 12. the train step: differentiate and fit ----------------------
    def train(self):
        """BASELINE config 4 on the card: nefertiti at 1024x1024 under the
        turbo knobs, verts and the materials and light trainable, 6 steps
        of fit() against the self-demo target with a rebuild after step 3;
        the forward under autograd bitwise render()'s image; card against
        CPU on the gradcheck scene with soft visibility and soft primary;
        kernel C's first launch held to its plain version."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_calls

        size, steps = 1024, 6
        trainable = ("verts", "base_color", "kd", "ks", "ka", "light_pos")
        prep = self.nef_prep
        prep_s = None
        if prep is None:
            scene, base = nefertiti_scene(size, size, device=self.dev)
            t0 = time.perf_counter()
            prep = prepare(apply_turbo(base, "nefertiti"), scene=scene)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
        target = render(prep)
        p = fitmod.split_scene(prep.scene)
        demo = prep._replace(scene=fitmod.merge_scene(
            p._replace(kd=p.kd * 1.5, base_color=p.base_color * 0.6), prep.scene))
        self.forward_under_autograd("nefertiti_1024", demo, trainable)

        # the fit, its steps timed with CUDA events and its rebuild on the host
        step_events, rebuild_s = [], []
        make_step, rebuild = fitmod.make_train_step, fitmod._rebuild

        def timed_make_step(*a, **kw):
            step, init = make_step(*a, **kw)

            def timed(*sa, **skw):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = step(*sa, **skw)
                ev[1].record()
                step_events.append(ev)
                return out
            return timed, init

        def timed_rebuild(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rebuild(*a, **kw)
            torch.cuda.synchronize()
            rebuild_s.append(time.perf_counter() - t0)
            return out

        torch.cuda.reset_peak_memory_stats()
        fitmod.make_train_step, fitmod._rebuild = timed_make_step, timed_rebuild
        try:
            self.zero_counts()
            with self.logging_launches() as log:
                t0 = time.perf_counter()
                params, losses = fitmod.fit(demo, target, steps=steps, lr=1e-2,
                                            trainable=trainable, rebuild_grid_every=3, log_every=0)
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
            counts = self.counts()
        finally:
            fitmod.make_train_step, fitmod._rebuild = make_step, rebuild
        self.path_launches["train_nefertiti"] = counts
        peak = torch.cuda.max_memory_allocated()
        if counts["packed_march"] <= 0:
            raise AssertionError("the fit launched packed_march 0 times")
        if len(log) != steps or len(rebuild_s) != 1:
            raise AssertionError(f"expected one launch of C a step and one rebuild, got "
                                 f"{len(log)} launches, {len(rebuild_s)} rebuilds")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"the fit's losses do not fall: {losses}")
        if not all(bool(torch.isfinite(x).all()) for x in params if x is not None):
            raise AssertionError("non-finite parameters after the fit")
        held = self.hold_logged("train step 0", log[:1])
        step_ms = [a.elapsed_time(b) for a, b in step_events]
        med_s = sorted(step_ms[1:])[len(step_ms[1:]) // 2] / 1e3

        # a three-step profiler window of the train step at the fitted params
        step, init = fitmod.make_train_step(prep.packed.meta, prep.cfg, lr=1e-2,
                                            trainable=trainable)
        tp, opt = init(params)
        consts = prep.frame().consts
        prof = profile_calls(lambda: step(tp, opt, prep.scene, prep.packed.arrays, target,
                                          consts=consts), med_s, "train_nefertiti_1024", 3)
        emit({"phase": "train", "config": "nefertiti_1024 (BASELINE config 4)", "size": size,
              "triangles": prep.scene.num_faces, "trainable": list(trainable), "steps": steps,
              "rebuild_grid_every": 3, "optimizer": "adam", "lr": 1e-2,
              "losses": losses, "step_ms": step_ms, "median_step_ms": med_s * 1e3,
              "mrays_per_s_fwd_bwd": size * size * 2 / med_s / 1e6,
              "rebuild_s": rebuild_s, "fit_s": fit_s, "prepare_s": prep_s,
              "max_memory_allocated_gib": peak / 2 ** 30, "launches": counts,
              "kernel_C_first_step": held,
              "device_busy_ms_per_step": prof["device_busy_ms"],
              "device_idle_share": prof["device_idle_share"],
              "device_kernels_per_step": prof["device_kernels"],
              "top_device_ms": prof["top_device_ms"]})
        self.train_card_vs_cpu()

    def forward_under_autograd(self, label, prep, trainable):
        """The colors the loss sees, every trainable leaf requiring grad,
        are render()'s image bit for bit."""
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import render

        img = render(prep)
        params = fitmod.split_scene(prep.scene)
        params = params._replace(**{f: getattr(params, f).clone().requires_grad_(True)
                                    for f in trainable})
        grid, meta = fitmod._grid_of(prep)
        colors = fitmod._colors(params, prep.scene, grid, meta, prep.cfg, prep.dda,
                                prep.frame().consts)
        if not colors.requires_grad:
            raise AssertionError(f"{label}: the loss's colors are not under autograd")
        n = int((colors.detach().reshape(img.shape).view(torch.int32)
                 != img.view(torch.int32)).sum())
        emit({"phase": "train_forward_bitwise", "config": label, "floats_differing": n})
        if n:
            raise AssertionError(f"{label}: the forward under autograd differs from render() "
                                 f"in {n} floats")

    def train_card_vs_cpu(self):
        """The gradcheck scene at 64x64 with soft visibility and soft primary
        (csr, kernel B): the forward under autograd bitwise render()'s on the
        card; the loss on the card against the CPU's to rtol 1e-6, every
        gradient leaf to rtol 1e-4 with atol 1e-6 max|g| (the CPU tests'
        tolerance against JAX)."""
        from ray_tracer_tpu_torch.models.scenes import gradcheck_scene
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare

        fields = ("verts", "base_color", "kd", "ka", "light_pos")
        out = {}
        for dev in ("cuda", "cpu"):
            scene, cfg = gradcheck_scene(64, 64, device=dev)
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, soft_visibility=0.1, soft_primary=0.08))
            prep = prepare(cfg, scene=scene)
            if dev == "cuda":
                self.forward_under_autograd("gradcheck_64_soft", prep, fields)
            target = torch.full((64, 64, 3), 40.0, device=dev)
            params = fitmod.split_scene(prep.scene)
            leaves = {f: getattr(params, f).clone().requires_grad_(True) for f in fields}
            self.zero_counts()
            loss = fitmod.image_loss(params._replace(**leaves), prep.scene, prep.grid.arrays,
                                     prep.grid.meta, cfg, target, dda=prep.dda)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            if dev == "cuda" and self.counts()["traverse_grid"] <= 0:
                raise AssertionError("the gradcheck loss launched traverse_grid 0 times")
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
        rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst = {}
        for f, g, w in zip(fields, out["cuda"][1], out["cpu"][1]):
            atol = 1e-6 * float(w.abs().max())
            excess = (g - w).abs() - (atol + 1e-4 * w.abs())
            worst[f] = float((g - w).abs().max())
            if bool((excess > 0).any()) or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"gradcheck 64x64: gradient {f} card vs CPU beyond "
                                     f"rtol 1e-4, atol {atol:.3g}")
        emit({"phase": "train_card_vs_cpu", "config": "gradcheck_64 soft_visibility 0.1 "
              "soft_primary 0.08", "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
              "loss_rel_err": rel, "grad_max_abs_err": worst,
              "tolerance": "loss rtol 1e-6; gradients rtol 1e-4, atol 1e-6 max|g|"})
        if rel > 1e-6:
            raise AssertionError(f"gradcheck 64x64: loss card vs CPU rel err {rel:.3g}")
        self.silhouette_fd()

    def silhouette_fd(self):
        """soft_primary 0.08 on one triangle at 16x16 on the card: the
        vertex gradients that drag its silhouette across pixel centres
        against central differences (rtol 5e-2, as the CPU test)."""
        import numpy as np

        from ray_tracer_tpu_torch.config import (
            CameraConfig, LightConfig, MaterialConfig, RenderConfig, SceneConfig,
        )
        from ray_tracer_tpu_torch.io.obj import MeshArrays
        from ray_tracer_tpu_torch.models.scenes import scene_from_meshes
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare

        tri = MeshArrays(verts=np.array([[-1.2, -1.0, 0.0], [1.2, -1.0, 0.0], [0.0, 1.2, 0.0]],
                                        np.float32),
                         faces=np.array([[0, 1, 2]], np.int32),
                         uvs=np.zeros((1, 2), np.float32), uv_faces=np.zeros((1, 3), np.int32))
        mat = MaterialConfig(base_color=(220.0, 160.0, 40.0), kd=2.0, ks=1.0, spec_alpha=4.0,
                             ka=0.3)
        light = LightConfig(position=(0.0, 0.0, 6.0), intensity=1.0)
        cfg = SceneConfig(
            materials=(mat,), light=light,
            camera=CameraConfig(position=(0.0, 0.0, 4.0), target=(0, 0, 0), up=(0, 1, 0),
                                fov_degrees=45.0, width=16, height=16),
            render=RenderConfig(shading="parallel", faithful=False, max_bounces=0,
                                shadow_eps=1e-3, shadow_scale=0.5, soft_primary=0.08))
        prep = prepare(cfg, scene=scene_from_meshes([(tri, 0)], [mat], light, device=self.dev))
        target = torch.zeros((16, 16, 3), device=self.dev)
        params = fitmod.split_scene(prep.scene)

        def loss_of(verts):
            return fitmod.image_loss(params._replace(verts=verts), prep.scene, prep.grid.arrays,
                                     prep.grid.meta, cfg, target, dda=prep.dda)

        verts = params.verts.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_of(verts), verts)
        out, eps = [], 2e-3
        for idx in ((0, 0), (2, 1)):
            with torch.no_grad():
                up, down = params.verts.clone(), params.verts.clone()
                up[idx] += eps
                down[idx] -= eps
                fd = (float(loss_of(up)) - float(loss_of(down))) / (2 * eps)
            analytic = float(g[idx])
            out.append({"vertex": list(idx), "autodiff": analytic, "fd": fd})
            if not abs(analytic - fd) <= 1e-7 + 5e-2 * abs(fd):
                raise AssertionError(f"silhouette gradient {idx}: autodiff {analytic} vs "
                                     f"finite differences {fd}")
        emit({"phase": "train_silhouette_fd", "size": 16, "soft_primary": 0.08,
              "checks": out, "tolerance": "rtol 5e-2, atol 1e-7"})

    def appearance(self):
        """The appearance epilogues on the card: kernel F's feature
        instantiations against the plain wave on their cases; the GI row's
        configuration with smooth normals, an image texture and an
        environment map at 1024^2 through render() (F once a frame), held
        bitwise to the plain wave and timed beside the featureless row; and
        the Whitted bounce loop with all three at 1024^2, card against CPU
        at 64^2 by the 2-count rule."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import build_scene, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        # 1. kernel F against its plain version on every feature case
        err = 0.0
        out = []
        for name, cfg, scene in self.appearance_cases():
            prep = prepare(cfg, scene=scene)
            if not prep.setup.gi_wave:
                raise AssertionError(f"appearance {name}: the config should take the GI wave")
            e, events, passes = self.gi_check(f"kernel F {name}", prep)
            err = max(err, e)
            g = prep.gi
            out.append({"case": name, "pixels": cfg.camera.width * cfg.camera.height,
                        "S": cfg.render.gi_samples, "D": cfg.render.gi_depth,
                        "env": prep.scene.env_image is not None, "smooth": g.fvn9 is not None,
                        "texture": (None if g.fuv7 is None
                                    else "image" if g.tex_image is not None else "checker"),
                        "mirror_mix": g.km is not None, "events": events, "passes": passes})
        self.err["gi_wave"] = max(self.err["gi_wave"], err)
        emit({"phase": "appearance_kernel_F_vs_plain", "cases": out, "max_abs_err": err,
              "tolerance": "bitwise (radiance and every counter)", "equal": True})

        # 2. the GI row's configuration with all three features, and without
        tex, env = self.appearance_images()
        size, S, D = 1024, 4, 2
        rows = {}
        for name, feats in (("gi_spot_1024_s4d2", {}),
                            ("gi_spot_1024_s4d2_appearance",
                             dict(normal_mode="smooth", texture="image"))):
            cfg = self.gi_config(serial_scene_config, size, "serial", S, D, **feats)
            scene = None
            if feats:
                scene = build_scene(cfg)._replace(texture_image=tex, env_image=env)
            p = prepare(cfg, scene=scene)
            self.zero_counts()
            img = render(p)
            torch.cuda.synchronize()
            counts = self.counts()
            if counts["gi_wave"] != 1 or sum(counts.values()) != 1:
                raise AssertionError(f"{name} launched {counts}: F once and nothing else "
                                     "expected")
            self.path_launches[name] = counts
            if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name}: bad image {tuple(img.shape)}")
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    render(p)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            med = sorted(secs)[2]
            prof = profile_render(p, med, name)
            tail, kw, _ = self.gi_inputs(p)
            f_dev_ms, _ = calls_device_ms(lambda: self.gi_launch(p, tail, kw), 10)
            rows[name] = {"median_ms": med * 1e3, "renders_ms": [x * 1e3 for x in secs],
                          "device_busy_ms": prof["device_busy_ms"],
                          "device_idle_share": prof["device_idle_share"],
                          "kernel_F_device_ms": f_dev_ms, "launches": counts}
            if feats:
                e, events, passes = self.gi_check(f"kernel F {name}", p)
                self.err["gi_wave"] = max(self.err["gi_wave"], e)
                rows[name].update(events=events, passes=passes, max_abs_err=e,
                                  bitwise_vs_plain=True,
                                  images={"texture": list(tex.shape), "env": list(env.shape)})
        regs = {k: v for k, v in self.ptxas.get("gi_wave", {}).items()
                if k.startswith(("gi_primary_kernel", "gi_sample_kernel"))}
        for k in ("gi_primary_kernelILb0ELb0ELi0EE", "gi_sample_kernelILb0ELb0ELi0EE"):
            if k not in regs or regs[k].get("spill_stores", 0) or regs[k].get("spill_loads", 0):
                raise AssertionError(f"the featureless stage {k} spills or is missing: "
                                     f"{regs.get(k)}")
        emit({"phase": "appearance_gi", "size": size, "S": S, "D": D, "rows": rows,
              "ptxas_by_instantiation": regs,
              "instantiation_keys": "gi_<stage>_kernelILb<env>ELb<smooth>ELi<texture: 0 none, "
                                    "1 checker, 2 image>EE"})

        # 3. the Whitted bounce loop with all three features
        def whitted(n, device):
            cfg = apply_turbo(serial_scene_config(n, n), "serial")
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, normal_mode="smooth", texture="image"))
            scene = build_scene(cfg, device=device)._replace(
                texture_image=tex.to(device), env_image=env.to(device))
            return prepare(cfg, scene=scene)

        p = whitted(1024, "cuda")
        self.zero_counts()
        img = render(p)
        torch.cuda.synchronize()
        counts = self.counts()
        if counts["packed_march"] < 1 or counts["whitted_wave"] or counts["gi_wave"]:
            raise AssertionError(f"the Whitted appearance frame launched {counts}: C, not E "
                                 "or F, expected")
        self.path_launches["turbo_spot_whitted_appearance"] = counts
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("the Whitted appearance frame has non-finite colors")
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            render(p)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        a = tonemap_u8(render(whitted(64, "cuda")).cpu().numpy())
        b = tonemap_u8(render(whitted(64, "cpu")).numpy())
        frac = image_rule(a, b)
        emit({"phase": "appearance_whitted", "size": 1024, "config": "turbo serial, smooth, "
              "image texture 256x256, env 256x512", "launches": counts,
              "median_ms": sorted(secs)[2] * 1e3, "renders_ms": [x * 1e3 for x in secs],
              "card_vs_cpu_64": {"bytes_differing": int((a != b).sum()),
                                 "pixels_over_2_counts": frac,
                                 "tolerance": "under 1% of pixels over 2 counts"}})
        if frac >= 0.01:
            raise AssertionError(f"Whitted appearance 64 card vs CPU: {frac:.2%} of pixels "
                                 "differ by > 2")

    def wave_pow_probe(self, cfg, prep, lanes):
        """The wave's plain version on the card over the differing pixels'
        CPU camera rays, twice: with torch.pow on the card, and with each
        pow's inputs taken to the CPU and torch.pow there.  Reports the pow
        inputs whose results differ and whether pow on the CPU alone gives
        the CPU's colors."""
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.ops import shade

        kE = self.kE
        tail, kw, rays = self.wave_inputs(cfg, prep)
        sub = RayBatch(*(x[lanes] for x in rays))
        cpu_tail = tuple(x.cpu() if torch.is_tensor(x) else x for x in tail[:4]) + (
            type(tail[4])(*(x.cpu() for x in tail[4])), tail[5])
        want = kE.whitted_wave_plain(RayBatch(*(x.cpu() for x in sub)), *cpu_tail, **kw)
        seen = []

        def card_pow(base, e):
            pos = base > 0
            seen.append((base[pos], e[pos]))
            return shade._pow_safe(base, e)

        def host_pow(base, e):
            return shade._pow_safe(base.cpu(), e.cpu()).to(base.device)

        try:
            kE._pow_safe = card_pow
            on_card = kE.whitted_wave_plain(sub, *tail, **kw).cpu()
            kE._pow_safe = host_pow
            host = kE.whitted_wave_plain(sub, *tail, **kw).cpu()
        finally:
            kE._pow_safe = shade._pow_safe
        base = torch.cat([b for b, _ in seen])
        e = torch.cat([x for _, x in seen])
        p_card = torch.pow(base, e).cpu()
        p_cpu = torch.pow(base.cpu(), e.cpu())
        bad = (p_card.view(torch.int32) != p_cpu.view(torch.int32)).nonzero()[:, 0]
        examples = [{"base": float(base[i]), "exponent": float(e[i]), "card": float(p_card[i]),
                     "cpu": float(p_cpu[i])} for i in bad[:8].tolist()]
        return {"pixels": int(lanes.numel()), "pow_inputs": int(base.numel()),
                "pow_results_differing": int(bad.numel()), "examples": examples,
                "card_plain_equals_cpu": bool(torch.equal(on_card.view(torch.int32),
                                                          want.view(torch.int32))),
                "card_plain_with_cpu_pow_equals_cpu": bool(
                    torch.equal(host.view(torch.int32), want.view(torch.int32)))}

    # ---- 9. kernel D through the gather tool -----------------------------
    def kernel_d(self):
        kD = self.kD
        chk = kD.check(device=self.dev)
        self.err["gather_row_test"] = max(self.err["gather_row_test"], chk["max_abs_err"])
        emit(dict(chk, phase="kernel_D_vs_plain"))
        self.zero_counts()
        bench = kD.bench(device=self.dev)
        counts = self.counts()
        if counts["gather_row_test"] <= 0:
            raise AssertionError("the gather tool's step loop launched kernel D 0 times")
        self.launches["gather_row_test"] = counts["gather_row_test"]
        self.times["D_bench"] = bench
        emit(dict(bench, phase="gather_bench", launches=counts["gather_row_test"]))

    # ---- kernel times at the main path's shapes --------------------------
    def kernel_times(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.ops.persistent import persistent_trace
        from ray_tracer_tpu_torch.render.renderer import prepare, shadow_rays_for

        kA, kB, kC, kD = self.kA, self.kB, self.kC, self.kD
        dev = self.dev
        main_cfg = serial_scene_config(1024, 1024)
        p = prepare(main_cfg)
        grid, meta = p.grid.arrays, p.grid.meta
        v0, v1, v2 = p.scene.triangle_soa()
        n_tris = v0.shape[0]
        tri9_soa = kA.triangle_table(v0, v1, v2)
        tri9_rows = kB.vertex_table(v0, v1, v2)
        rays = camera_rays(main_cfg.camera, device=dev)
        r = rays.count
        eps = main_cfg.render.shadow_eps

        def shadow_of(cfg, t, hit):
            poi = torch.where(hit[:, None], rays.at(torch.where(hit, t, torch.zeros_like(t))),
                              torch.zeros_like(rays.orig))
            return shadow_rays_for(cfg.render, p.scene.light_pos, poi, hit)

        def bound(n_bytes, n_ops):
            """(bound ms, what bounds it): bytes at the HBM rate, operations
            at the unfused FP32 rate (every kernel builds with -fmad=false)."""
            tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32_UNFUSED
            return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

        # Inputs are made once; each kernel's time is n back-to-back launches
        # over n, its device time the profiler's mean for the kernel alone.
        def launch_a():
            return kA.brute_intersect_cuda(rays.orig, rays.dirn, tri9_soa, 0.0)

        a_ms = cuda_ms(launch_a, 5)
        a_dev_ms = calls_device_ms(launch_a, 3, "brute_intersect_kernel")[0]
        a_out = launch_a()
        a_plain_ms, a_plain = once_ms(
            lambda: kA.brute_intersect_plain(rays.orig, rays.dirn, tri9_soa, 0.0))
        self.err["brute_intersect"] = max(self.err["brute_intersect"],
                                          compare("kernel A 1024 primary", a_out, a_plain))
        a_ops = r * n_tris * OPS_PER_PAIR_A
        a_bytes = r * (24 + 8) + n_tris * 36
        a_bound, a_by = bound(a_bytes, a_ops)

        # kernel B: the csr frame's primary launch over prepare's tables
        kw = dict(det_dtype=main_cfg.render.det_dtype, t_gate=main_cfg.render.primary_gate(),
                  early_exit=not main_cfg.render.faithful, tables=p.dda)

        def launch_b(**extra):
            return kB.traverse_grid_cuda(rays, grid, meta, tri9_rows, **kw, **extra)

        b_ms = cuda_ms(launch_b, 50)
        b_dev_ms = calls_device_ms(launch_b, 20, "traverse_grid_kernel")[0]
        tested = torch.zeros((r,), dtype=torch.int32, device=dev)
        b_passes = torch.zeros((1,), dtype=torch.int32, device=dev)
        b_out = launch_b(tested_out=tested, passes_out=b_passes)
        pkw_b = {k: v for k, v in kw.items() if k != "tables"}
        b_plain_ms, b_plain = once_ms(
            lambda: kB.traverse_grid_plain(rays, grid, meta, tri9_rows, **pkw_b))
        b_err = compare("kernel B 1024 primary", b_out, b_plain)
        # the frame's second launch of each kernel: the shadow rays of its hits
        fast = dataclasses.replace(main_cfg, render=dataclasses.replace(
            main_cfg.render, faithful=False))
        sa = shadow_of(fast, a_out[0], a_out[1] >= 0)
        a_shadow_ms = cuda_ms(lambda: kA.brute_intersect_cuda(sa.orig, sa.dirn, tri9_soa, eps), 5)
        sb = shadow_of(main_cfg, b_out.t, main_cfg.render.accepted_hit(b_out))

        def launch_b_shadow(**extra):
            return kB.traverse_grid_cuda(
                sb, grid, meta, tri9_rows, det_dtype=kw["det_dtype"], t_gate=eps,
                early_exit=kw["early_exit"], stop_on_first_hit=kw["early_exit"],
                tables=p.dda, **extra)

        b_shadow_ms = cuda_ms(launch_b_shadow, 50)
        b_shadow_dev_ms = calls_device_ms(launch_b_shadow, 20, "traverse_grid_kernel")[0]
        self.err["traverse_grid"] = max(self.err["traverse_grid"], b_err)
        n_tests = int(tested.sum())
        n_passes = int(b_passes.item())
        if not int(b_out.any_pass.sum()) <= n_passes <= n_tests:  # a passing ray passes once
            raise AssertionError(f"kernel B counted {n_passes} passes of {n_tests} tests")
        n_steps = int(b_out.steps.sum())
        # each input of the function read once, each output written once:
        # the rays (32 B) and five results (14 B), the CSR arrays and the
        # vertex table.  The kernel's own tables (mask, int2 pairs, vertices
        # in CSR order) are derived from those inputs and not counted: the
        # bound counts the same work whatever implements it.
        b_bytes = (r * (32 + 14) + (grid.cell_start.numel() + grid.tri_ids.numel()) * 4
                   + tri9_rows.numel() * 4)
        b_ops = (n_tests - n_passes) * OPS_PER_FAILED_TEST + n_passes * OPS_PER_PASSED_TEST
        b_bound, b_by = bound(b_bytes, b_ops)

        # kernel C: the turbo frame's one launch, the fused persistent march
        tcfg = apply_turbo(main_cfg, "serial")
        tp = prepare(tcfg)
        pgrid, pmeta = tp.packed.arrays, tp.packed.meta
        trc = tcfg.render
        ckw = dict(wave=trc.wave, fuse_shadow=True, t_gate=0.0, shadow_gate=trc.shadow_eps,
                   shadow_mint=trc.shadow_mint(), serial_quirk=True, shadow_skip_dead=True,
                   shade_serial=True, need_t=True, need_steps=True, need_shadow_tri=True)
        light = tp.scene.light_pos

        def launch_c():
            return persistent_trace(rays, pgrid, pmeta, light, **ckw)

        c_ms = cuda_ms(launch_c, 20)
        c_dev_ms = calls_device_ms(launch_c, 10, "packed_march")[0]
        pkw = dict(fused=True, t_gate=0.0, shadow_gate=trc.shadow_eps,
                   shadow_mint=trc.shadow_mint(), serial_quirk=True, skip_dead_shadow=True,
                   shade_serial=True)
        c_plain_ms, c_plain = once_ms(lambda: kC.march_plain(rays, pgrid, pmeta, light, **pkw))
        c_err = compare("kernel C 1024 turbo", launch_c(), c_plain)
        # the same march with its counters: rows tested and touched, passes
        c_tested = torch.zeros((r,), dtype=torch.int32, device=dev)
        touched = torch.zeros((pmeta.n_blocks,), dtype=torch.int32, device=dev)
        capped = torch.zeros((1,), dtype=torch.int32, device=dev)
        c_passes = torch.zeros((1,), dtype=torch.int32, device=dev)
        c_out = kC.march_cuda(rays, pgrid, pmeta, light, tested_out=c_tested,
                              touched_out=touched, capped_out=capped, passes_out=c_passes,
                              **pkw)
        c_err = max(c_err, compare("kernel C 1024 turbo counted", c_out, c_plain))
        if int(capped.item()):
            raise AssertionError(f"kernel C 1024: {int(capped)} rays capped")
        self.err["packed_march"] = max(self.err["packed_march"], c_err)
        rows_tested = int(c_tested.sum())
        full_rows = int(((touched & 2) != 0).sum())
        header_rows = int((touched == 1).sum())
        c_hits = int(c_out.hit.sum())
        c_shadow = int(c_out.in_shadow.sum())
        # rays in (32 B), six record fields out (18 B), each distinct row
        # tested once (row_lanes * 4 B), each header-only row's 8 B, and
        # one slot_tri entry per primary hit and per blocker
        c_bytes = (r * (32 + 18) + full_rows * pmeta.row_lanes * 4 + header_rows * 8
                   + (c_hits + c_shadow) * 4)
        slot_tests = rows_tested * pmeta.block_tris
        c_pass = int(c_passes.item())
        if not 0 <= c_pass <= slot_tests:
            raise AssertionError(f"kernel C counted {c_pass} passes of {slot_tests} tests")
        c_ops = (slot_tests - c_pass) * OPS_PER_FAILED_TEST + c_pass * OPS_PER_PASSED_TEST
        c_bound, c_by = bound(c_bytes, c_ops)

        # kernel D at the gather tool's shapes (W = 8192 lanes, NB = 2270 rows)
        blocks, o, d, idx0 = kD.make_inputs(device=dev)

        def launch_d():
            return kD.gather_row_test_cuda(blocks, o, d, idx0)

        d_ms = cuda_ms(launch_d, 200)
        d_dev_ms = calls_device_ms(launch_d, 50, "gather_row_test_kernel")[0]
        d_plain_ms, d_plain = once_ms(lambda: kD.gather_row_test_plain(blocks, o, d, idx0))
        self.err["gather_row_test"] = max(self.err["gather_row_test"],
                                          compare("kernel D", (launch_d(),), (d_plain,)))
        w, tl = idx0.shape[0], blocks.shape[2]
        d_rows = int(torch.unique(idx0).numel())
        d_bytes = d_rows * 9 * tl * 4 + w * (24 + 4) + w * 4
        d_ops = w * tl * OPS_PER_LANE_D
        d_bound, d_by = bound(d_bytes, d_ops)

        e = self.wave_times(bound)
        f = self.gi_times(bound)

        self.times.update(
            E=e, F=f,
            A=dict(ms=a_ms, plain_ms=a_plain_ms, bound_ms=a_bound, bound_by=a_by),
            B=dict(ms=b_ms, plain_ms=b_plain_ms, bound_ms=b_bound, bound_by=b_by),
            C=dict(ms=c_ms, plain_ms=c_plain_ms, bound_ms=c_bound, bound_by=c_by),
            D=dict(ms=d_ms, plain_ms=d_plain_ms, bound_ms=d_bound, bound_by=d_by),
        )
        emit({"phase": "kernel_times", "rays": r, "triangles": n_tris,
              "A": {"ms": a_ms, "device_ms": a_dev_ms, "shadow_ms": a_shadow_ms,
                    "plain_ms": a_plain_ms, "ops": a_ops, "bytes": a_bytes, "bound_ms": a_bound,
                    "bound_fma_peak_ms": a_ops / PEAK_FP32_OPS * 1e3},
              "B": {"ms": b_ms, "device_ms": b_dev_ms, "shadow_ms": b_shadow_ms,
                    "shadow_device_ms": b_shadow_dev_ms,
                    "plain_ms": b_plain_ms, "previous_ms": PREVIOUS_MS["B"],
                    "mask_bytes": p.dda.occupancy.numel() * 4,
                    "ptxas": self.ptxas.get("traverse_grid"),
                    "steps": n_steps, "tested_triangles": n_tests, "passes": n_passes,
                    "occupied_cells": int((p.dda.cell_range[:, 1] > 0).sum()),
                    "cells": p.dda.cell_range.shape[0],
                    "bytes": b_bytes, "ops": b_ops, "bound_ms": b_bound, "bound_by": b_by,
                    "bound_bytes_ms": b_bytes / PEAK_BYTES * 1e3,
                    "bound_ops_ms": b_ops / PEAK_FP32_UNFUSED * 1e3},
              "C": {"ms": c_ms, "device_ms": c_dev_ms,
                    "plain_ms": c_plain_ms, "previous_ms": PREVIOUS_MS["C"],
                    "device_vs_previous": (c_dev_ms / PREVIOUS_MS["C"]["device_ms"]
                                           if c_dev_ms else None),
                    "ptxas": self.ptxas.get("packed_march"),
                    "steps": int(c_out.steps.sum()), "max_steps": int(c_out.steps.max()),
                    "rows_tested": rows_tested, "slot_tests": slot_tests, "passes": c_pass,
                    "distinct_rows_tested": full_rows,
                    "header_only_rows": header_rows, "table_rows": pmeta.n_blocks,
                    "hits": c_hits, "in_shadow": c_shadow, "bytes": c_bytes, "ops": c_ops,
                    "bound_ms": c_bound, "bound_by": c_by,
                    "bound_ops_ms": c_ops / PEAK_FP32_UNFUSED * 1e3,
                    "bound_bytes_ms": c_bytes / PEAK_BYTES * 1e3},
              "D": {"ms": d_ms, "device_ms": d_dev_ms, "plain_ms": d_plain_ms,
                    "lanes": w, "distinct_rows": d_rows, "bytes": d_bytes, "ops": d_ops,
                    "bound_ms": d_bound, "bound_ops_fma_peak_ms": d_ops / PEAK_FP32_OPS * 1e3,
                    "bound_bytes_ms": d_bytes / PEAK_BYTES * 1e3}})

    def wave_times(self, bound) -> dict:
        """Kernel E at the main path's shape, the turbo parallel 1024^2
        frame: events over n launches, the profiler's device time, the plain
        version once (held bitwise), and the bound from a counted launch
        whose six counters equal the plain version's."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare

        kE = self.kE
        if self.wave_frame is None:
            cfg = apply_turbo(parallel_scene_config(1024, 1024), "parallel")
            self.wave_frame = (cfg, prepare(cfg))
        cfg, p = self.wave_frame
        tail, kw, rays = self.wave_inputs(cfg, p)
        r = rays.count

        def launch_e(**extra):
            return self.wave_launch(cfg, p, tail, kw, **extra)

        e_ms = cuda_ms(launch_e, 20)
        e_dev_ms = calls_device_ms(launch_e, 10, "whitted_wave_kernel")[0]
        e_plain_ms, e_plain = once_ms(lambda: kE.whitted_wave_plain(rays, *tail, **kw))
        err = compare("kernel E 1024 turbo parallel", (launch_e().reshape(-1),),
                      (e_plain.reshape(-1),))
        self.err["whitted_wave"] = max(self.err["whitted_wave"], err)
        lanes = torch.zeros((2,), dtype=torch.int64, device=self.dev)
        launch_e(lanes_out=lanes)
        warp_iters, lane_steps = lanes.tolist()
        emit({"phase": "lane_utilisation_before", "kernel": "E",
              "design": "one thread a queue position (recorded in PERF.md)",
              "lane_utilisation": PREVIOUS_E["lane_utilisation"],
              "device_ms": PREVIOUS_E["device_ms"]})
        emit({"phase": "lane_utilisation_after", "kernel": "E",
              "design": "persistent wave, half-warp refill", "warp_iterations": warp_iters,
              "active_lane_steps": lane_steps,
              "lane_utilisation": lane_steps / (32 * warp_iters), "device_ms": e_dev_ms})
        # E's counters on this frame against the plain version's, all six
        ck, cp = self.wave_counters(p, r), self.wave_counters(p, r)
        self.wave_launch(cfg, p, tail, kw, **ck)
        kE.whitted_wave_plain(rays, *tail, **kw, **cp)
        torch.cuda.synchronize()
        for key in ck:
            if not torch.equal(ck[key], cp[key]):
                raise AssertionError(f"kernel E 1024: counter {key} differs from the plain "
                                     "version's")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"kernel E 1024: {int(ck['capped_out'])} lanes capped")
        meta, grid = p.packed.meta, p.packed.arrays
        events = dict(zip(kE.EVENTS, ck["events_out"].tolist()))
        rows_tested = int(ck["tested_out"].sum())
        slot_tests = rows_tested * meta.block_tris
        passes = int(ck["passes_out"].item())
        if not 0 <= passes <= slot_tests:
            raise AssertionError(f"kernel E counted {passes} passes of {slot_tests} tests")
        touched = ck["touched_out"]
        full_rows = int(((touched & 2) != 0).sum())
        header_rows = int((touched == 1).sum())
        slots = ck["slots_out"].nonzero()[:, 0]
        tris = torch.unique(grid.slot_tri[slots])
        mats = torch.unique(p.scene.face_material[tris.long()])
        # the camera's launch values in (its subsample table) and colors out
        # (12 B), each distinct row tested once (row_lanes * 4 B), each
        # header-only row's 8 B, and the slot_tri entries, tri9 rows (40 B)
        # and mat9 rows (36 B) the vertices used
        e_bytes = (p.setup.cam.table.numel() * 4 + r * 12 + full_rows * meta.row_lanes * 4
                   + header_rows * 8 + slots.numel() * 4 + tris.numel() * 40
                   + mats.numel() * 36)
        e_ops = ((slot_tests - passes) * OPS_PER_FAILED_TEST + passes * OPS_PER_PASSED_TEST
                 + r * OPS_PER_CAMERA_RAY_E
                 + events["vertices"] * OPS_PER_VERTEX_E
                 + events["reflections"] * OPS_PER_REFLECTION_E)
        e_bound, e_by = bound(e_bytes, e_ops)
        segments = events["primaries"] + events["shadow_rays"] + events["mirror_rays"]
        emit({"phase": "kernel_times_E", "positions": r, "ms": e_ms, "device_ms": e_dev_ms,
              "previous": PREVIOUS_E, "plain_ms": e_plain_ms, "ptxas": self.ptxas.get("whitted_wave"),
              "events": events, "segments": segments,
              "segments_per_s_of_kernel": segments / ((e_dev_ms or e_ms) / 1e3),
              "rows_tested": rows_tested, "slot_tests": slot_tests, "passes": passes,
              "distinct_rows_tested": full_rows, "header_only_rows": header_rows,
              "slots_used": slots.numel(), "triangles_used": tris.numel(),
              "materials_used": mats.numel(), "bytes": e_bytes, "ops": e_ops,
              "bound_ms": e_bound, "bound_by": e_by,
              "bound_bytes_ms": e_bytes / PEAK_BYTES * 1e3,
              "bound_ops_ms": e_ops / PEAK_FP32_UNFUSED * 1e3, "max_abs_err": err,
              "counters_equal_plain": True})
        return dict(ms=e_ms, plain_ms=e_plain_ms, bound_ms=e_bound, bound_by=e_by)

    def gi_times(self, bound) -> dict:
        """Kernel F at the main path's shape, the official GI row (turbo
        serial 1024^2, S = 4, D = 2): events over n calls, the profiler's
        device time of a call (its three kernels and memset summed, and each
        beside the sum), the lane utilisation, the plain version once (held
        bitwise), and the bound from a counted call whose counters equal the
        plain version's."""
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare

        kF = self.kF
        if self.gi_frame is None:
            self.gi_frame = prepare(self.gi_config(serial_scene_config, 1024, "serial", 4, 2))
        p = self.gi_frame
        tail, kw, rays = self.gi_inputs(p)
        r = rays.count

        def launch_f(**extra):
            return self.gi_launch(p, tail, kw, **extra)

        f_ms = cuda_ms(launch_f, 20)
        # F is several kernels and a memset: its device time is their sum
        f_dev_ms, by_name = calls_device_ms(launch_f, 10)
        f_by_kernel = {}
        for name, ms in by_name.items():
            short = re.search(r"gi_\w+_kernel|Memset", name)
            key = short.group(0) if short else name[:60]
            f_by_kernel[key] = f_by_kernel.get(key, 0.0) + ms
        lanes = torch.zeros((2, 3), dtype=torch.int64, device=self.dev)
        launch_f(lanes_out=lanes)
        ln = lanes.tolist()
        iters = ln[0][0] + ln[1][0]
        emit({"phase": "lane_utilisation_before", "kernel": "F",
              "design": "one thread a pixel serving all its samples, no queue (recorded in "
                        "PERF.md)", **PREVIOUS_F})
        emit({"phase": "lane_utilisation_after", "kernel": "F",
              "design": "stage P, a persistent refilled stage S of sample items, the fold",
              "lanes": {"stage_P": ln[0], "stage_S": ln[1],
                        "keys": ["warp_iterations", "active_lane_steps", "transition_steps"]},
              "lane_utilisation": (ln[0][1] + ln[1][1]) / (32 * iters),
              "lane_utilisation_by_stage": [x[1] / (32 * x[0]) if x[0] else None for x in ln],
              "transition_share": (ln[0][2] + ln[1][2]) / iters, "device_ms": f_dev_ms})
        cp, ck = self.gi_counters(), self.gi_counters()
        f_plain_ms, f_plain = once_ms(lambda: kF.gi_wave_plain(rays, *tail, **kw, **cp))
        err = compare("kernel F 1024 GI", (launch_f(**ck).reshape(-1),), (f_plain.reshape(-1),))
        torch.cuda.synchronize()
        for key in ck:
            if not torch.equal(ck[key], cp[key]):
                raise AssertionError(f"kernel F 1024: counter {key} differs from the plain "
                                     "version's")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"kernel F 1024: {int(ck['capped_out'])} pixels capped")
        self.err["gi_wave"] = max(self.err["gi_wave"], err)
        meta, grid = p.packed.meta, p.packed.arrays
        events = dict(zip(kF.EVENTS, ck["events_out"].tolist()))
        passes = int(ck["passes_out"].item())
        slot_tests = events["slot_tests"]
        if not 0 <= passes <= slot_tests:
            raise AssertionError(f"kernel F counted {passes} passes of {slot_tests} tests")
        tri9, albedo, km = p.gi.tri9, p.gi.albedo, p.gi.km
        # every input read once and the radiance written once: the whole
        # grid tables (an upper bound of the rows the frame reads: F keeps
        # no per-row counter, and the bytes term does not bind), the
        # triangle rows, the material tables, the camera table
        f_bytes = (r * 12 + (grid.blocks.numel() + grid.slot_tri.numel()
                             + grid.cell_info.numel()) * 4 + tri9.numel() * 4
                   + albedo.numel() * 4 + (km.numel() * 4 if km is not None else 0)
                   + p.setup.cam.table.numel() * 4)
        f_ops = ((slot_tests - passes) * OPS_PER_FAILED_TEST + passes * OPS_PER_PASSED_TEST
                 + r * OPS_PER_PIXEL_F + r * kw["S"] * OPS_PER_SAMPLE_F
                 + events["vertices"] * OPS_PER_VERTEX_F
                 + events["bounce_segments"] * OPS_PER_BOUNCE_F
                 + events["escapes"] * OPS_PER_ESCAPE_F)
        f_bound, f_by = bound(f_bytes, f_ops)
        segments = events["primaries"] + events["bounce_segments"] + events["shadow_rays"]
        emit({"phase": "kernel_times_F", "pixels": r, "S": kw["S"], "D": kw["D"], "ms": f_ms,
              "device_ms": f_dev_ms, "device_ms_by_kernel": f_by_kernel,
              "plain_ms": f_plain_ms, "ptxas": self.ptxas.get("gi_wave"),
              "events": events, "passes": passes, "segments": segments,
              "segments_per_s_of_kernel": segments / ((f_dev_ms or f_ms) / 1e3),
              "bytes": f_bytes, "ops": f_ops, "bound_ms": f_bound, "bound_by": f_by,
              "bound_bytes_ms": f_bytes / PEAK_BYTES * 1e3,
              "bound_ops_ms": f_ops / PEAK_FP32_UNFUSED * 1e3, "library_ms": None,
              "max_abs_err": err, "counters_equal_plain": True})
        return dict(ms=f_ms, plain_ms=f_plain_ms, bound_ms=f_bound, bound_by=f_by)

    def kernels_line(self):
        rows = []
        for name, key, source, replaces in (
            ("brute_intersect", "A", "ray_tracer_tpu_torch/csrc/brute_intersect.cu",
             "ray_tracer_tpu/ops/pallas_intersect.py:114"),
            ("traverse_grid", "B", "ray_tracer_tpu_torch/csrc/traverse_grid.cu",
             "ray_tracer_tpu/ops/traverse.py:91"),
            ("packed_march", "C", "ray_tracer_tpu_torch/csrc/packed_march.cu",
             "ray_tracer_tpu/ops/traverse_packed.py:152"),
            ("gather_row_test", "D", "ray_tracer_tpu_torch/csrc/gather_row_test.cu",
             "tools/pallas_gather_bench.py:98"),
            ("whitted_wave", "E", "ray_tracer_tpu_torch/csrc/whitted_wave.cu",
             "ray_tracer_tpu/ops/whitted_wave.py:79"),
            ("gi_wave", "F", "ray_tracer_tpu_torch/csrc/gi_wave.cu",
             "ray_tracer_tpu/ops/gi_wave.py:96"),
        ):
            t = self.times[key]
            rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": self.launches[name], "max_abs_err": self.err[name],
                         "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"], "library_ms": None})
        emit({"kernels": rows})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ",".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tracer_tpu_torch.tools.profiling import card_line

    card = card_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "card": card,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    smoke = Smoke()
    t_start = time.perf_counter()
    smoke.build()
    if phases & {"A", "B"}:
        smoke.kernels_ab(phases)
    if "C" in phases:
        smoke.kernel_c()
    if "E" in phases:
        smoke.kernel_e()
    if "F" in phases:
        smoke.kernel_f()
    if "main" in phases:
        smoke.main_path()
    if "card_vs_cpu" in phases:
        smoke.card_vs_cpu()
    if "appearance" in phases:
        smoke.appearance()
    if "train" in phases:
        smoke.train()
    if "D" in phases:
        smoke.kernel_d()
    if "times" in phases:
        smoke.kernel_times()
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    if phases >= set(ALL_PHASES):
        smoke.kernels_line()
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
