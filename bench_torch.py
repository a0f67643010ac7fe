"""The PyTorch/CUDA port's benchmark: the rows of BENCH_SUITE_r05.json on
one NVIDIA card.

    python3 bench_torch.py                      # all seven rows
    python3 bench_torch.py --rows gi_spot_1024_s4d2,parallel_1024
    python3 bench_torch.py --rows train_nefertiti_1024

Run from the repository root on a machine with a CUDA device; without one
it exits non-zero before any row.  Each row is the JAX package's bench.py
row (`SUITE`, bench.py:173-190) with the knobs bench.py derives from
TUNED_KNOBS (bench.py:373-447): the packed grid at the family's row width,
grid resolution and SAT-exact insertion, the persistent wave at its wave
and pump, the Whitted wave's own knee on the parallel scene and gi_pump on
the GI row.  bench.py picks `fused_shadow` and `camera_refill` by measured
probes, which the port does not have yet: every row here runs with
fused_shadow on (the turbo default) and camera_refill "auto" (which
changes no bit and no launch in the port), and the row says so.

Per row, after a warm-up frame (the first includes the kernels' build):
`--rounds` chains of `--repeat` frames, each chain timed with CUDA events
around its frames; the best chain is the record, the median and every
chain's time show the spread.  Mrays/s counts 2 rays a pixel (primary and
shadow, BASELINE.md's metric) on the Whitted rows; the GI row reports
Mpaths/s (pixels x samples a second) and the segments kernel F marched a
second (primaries, bounces and NEE shadow rays, from its counters), and
bench.py's own GI count (pixels x samples x 2 x (depth + 1)).  Then a
ten-frame torch.profiler window: the device's busy time a frame (the sum
of its kernels' durations) and the idle share of the median frame that
leaves.  Each row checks that its frame launched its kernel (C, E or F)
and is finite.  One JSON line a row; the last line holds all the rows,
the card's name and power limit and the PyTorch and CUDA versions.

The training row, train_nefertiti_1024 (BASELINE config 4), is bench.py
--grad on the nefertiti_1024 row's config with verts trainable beside
base_color, kd, ks, ka and light_pos: `opt.fit.make_train_step` (the
render under autograd, the L2 loss against a zero target, the backward,
Adam at lr 1e-3) with the grid held fixed, as fit does between rebuilds.
`--rounds` chains of 4 steps, each chain from the same parameters and a
fresh optimizer; seconds a step (best and median), Mrays/s forward +
backward at 2 rays a pixel (bench.py:100), a three-step profiler window's
busy time and idle share, and the peak device memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

ROWS = ("spot_1024", "spot_2048", "nefertiti_1024", "nefertiti_2048", "parallel_1024",
        "gi_spot_1024_s4d2", "train_nefertiti_1024")
# workload -> (scene, size, gi samples, gi depth), as bench.py's SUITE
SUITE = {
    "spot_1024": ("spot", 1024, 0, 2),
    "spot_2048": ("spot", 2048, 0, 2),
    "nefertiti_1024": ("nefertiti", 1024, 0, 2),
    "nefertiti_2048": ("nefertiti", 2048, 0, 2),
    "parallel_1024": ("parallel", 1024, 0, 2),
    "gi_spot_1024_s4d2": ("spot", 1024, 4, 2),
    "train_nefertiti_1024": ("nefertiti", 1024, 0, 2),
}
TRAINABLE = ("base_color", "kd", "ks", "ka", "light_pos", "verts")
TRAIN_STEPS = 4  # a timed chain of the training row
# the kernel each row's frame must launch (ops wrappers' launch counters)
ROW_KERNEL = {"spot": "packed_march", "nefertiti": "packed_march", "parallel": "whitted_wave"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def row_config(workload: str, size: int = None):
    """The config of a suite row at its size (or `size`), with bench.py's
    knobs from TUNED_KNOBS."""
    from ray_tracer_tpu_torch.config import TUNED_KNOBS, GridConfig
    from ray_tracer_tpu_torch.models import scenes

    name, full, gi, gi_depth = SUITE[workload]
    size = full if size is None else size
    k = TUNED_KNOBS[{"spot": "serial"}.get(name, name)]
    if name == "nefertiti":
        cfg = scenes.nefertiti_scene_config(size, size)
    elif name == "parallel":
        cfg = scenes.parallel_scene_config(size, size)
    else:
        cfg = scenes.serial_scene_config(size, size)
    wave, pump = k["wave"], k["pump"]
    whitted = "auto" if k.get("wwave") else "off"
    if k.get("wwave") and gi == 0:  # the Whitted wave's own knee
        wave, pump = k.get("wwave_wave", wave), k.get("wwave_pump", pump)
    if gi > 0:  # the GI wave's own pump knee
        pump = k.get("gi_pump", pump)
    render = dataclasses.replace(
        cfg.render, faithful=False, det_dtype="float32", traversal="packed", ray_tile=768,
        packed_block_tris=k["block_tris"], fused_shadow=True, scheduler="persistent",
        wave=wave, pump=pump, queue_order=k.get("order", "fifo"),
        probe_chain=k.get("chain", 1), grid_layout="auto", whitted_wave=whitted,
        grid=GridConfig(resolution_multiplier=k["rm"], max_resolution=k["max_res"],
                        exact_overlap=k["exact"]),
    )
    if gi > 0:
        render = dataclasses.replace(render, gi_samples=gi, gi_depth=gi_depth, gi_wave="auto")
    return dataclasses.replace(cfg, render=render)


def _kernel_counters():
    from ray_tracer_tpu_torch.ops import gi_wave, traverse_packed, whitted_wave

    return {"packed_march": traverse_packed.march_cuda,
            "whitted_wave": whitted_wave.whitted_wave_cuda, "gi_wave": gi_wave.gi_wave_cuda}


def gi_segments(prep) -> dict:
    """Kernel F's counters on this frame's inputs (one separate, counted
    launch): its EVENTS, and the segments it marched."""
    from ray_tracer_tpu_torch.ops import gi_wave

    args, kw = gi_wave.launch_inputs(prep)
    events = torch.zeros((len(gi_wave.EVENTS),), dtype=torch.int64, device=prep.device)
    gi_wave.gi_wave_cuda(prep.cfg.camera, *args, **kw, cam=prep.setup.cam,
                         consts=prep.setup.consts, events_out=events)
    ev = dict(zip(gi_wave.EVENTS, events.tolist()))
    ev["segments"] = ev["primaries"] + ev["bounce_segments"] + ev["shadow_rays"]
    return ev


def bench_row(workload: str, prep, repeat: int, rounds: int) -> dict:
    from ray_tracer_tpu_torch.render.renderer import render
    from ray_tracer_tpu_torch.tools.profiling import profile_render

    name, size, gi, gi_depth = SUITE[workload]
    kernel = "gi_wave" if gi else ROW_KERNEL[name]
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    img = render(prep)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches[kernel] <= 0:
        raise AssertionError(f"{workload}: the frame launched {kernel} 0 times ({launches})")
    if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{workload}: bad image {tuple(img.shape)}")
    chains = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(repeat):
            render(prep)
        b.record()
        torch.cuda.synchronize()
        chains.append(a.elapsed_time(b) / repeat / 1e3)
    sec = min(chains)
    med = sorted(chains)[len(chains) // 2]
    rc = prep.cfg.render
    row = {"workload": workload, "size": size, "triangles": prep.scene.num_faces,
           "seconds_per_frame": sec, "seconds_per_frame_median": med, "secs_chains": chains,
           "frames_per_chain": repeat, "first_frame_s": first_s,
           "launches_per_frame": launches,
           "knobs": {"block_tris": prep.packed.meta.block_tris, "wave": rc.wave,
                     "pump": rc.pump, "grid": list(prep.packed.meta.n_voxels),
                     "inline": prep.packed.meta.inline, "exact": rc.grid.exact_overlap,
                     "whitted_wave": rc.whitted_wave, "gi_wave": rc.gi_wave,
                     "fused_shadow": rc.fused_shadow, "camera_refill": rc.camera_refill,
                     "probes": "not ported: fused_shadow and camera_refill are fixed"}}
    if gi:
        ev = gi_segments(prep)
        paths = size * size * gi
        row.update(metric="gi_mrays_per_s_spot", gi_samples=gi, gi_depth=gi_depth,
                   value=paths * 2 * (gi_depth + 1) / sec / 1e6,
                   unit="Mrays/s (bench.py's count: path+NEE segments, 2 x (depth+1) a path)",
                   paths_per_s_m=paths / sec / 1e6, paths_per_s_m_median=paths / med / 1e6,
                   segments_marched=ev["segments"],
                   segments_marched_per_s=ev["segments"] / sec, kernel_F_events=ev)
    else:
        rays = size * size * 2
        row.update(metric=f"mrays_per_s_{name}_primary_shadow", value=rays / sec / 1e6,
                   unit="Mrays/s (primary + shadow)", value_median=rays / med / 1e6)
    prof = profile_render(prep, med, workload)
    row.update(device_kernels_per_frame=prof["device_kernels"],
               device_busy_ms=prof["device_busy_ms"],
               device_idle_share=prof["device_idle_share"],
               top_device_ms=prof["top_device_ms"])
    return row


def bench_train(workload: str, prep, rounds: int) -> dict:
    from ray_tracer_tpu_torch.opt.fit import make_train_step, split_scene
    from ray_tracer_tpu_torch.tools.profiling import profile_calls

    size = SUITE[workload][1]
    step, init = make_train_step(prep.packed.meta, prep.cfg, lr=1e-3, trainable=TRAINABLE)
    start = split_scene(prep.scene)
    target = torch.zeros((size, size, 3), device=prep.device)
    consts = prep.frame().consts
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    params, opt = init(start)
    t0 = time.perf_counter()
    params, opt, loss = step(params, opt, prep.scene, prep.packed.arrays, target, consts=consts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches["packed_march"] <= 0:
        raise AssertionError(f"{workload}: the step launched packed_march 0 times")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{workload}: non-finite loss")
    chains = []
    for _ in range(rounds):
        params, opt = init(start)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TRAIN_STEPS):
            params, opt, loss = step(params, opt, prep.scene, prep.packed.arrays, target,
                                     consts=consts)
        b.record()
        torch.cuda.synchronize()
        chains.append(a.elapsed_time(b) / TRAIN_STEPS / 1e3)
    sec = min(chains)
    med = sorted(chains)[len(chains) // 2]
    rays = size * size * 2
    prof = profile_calls(lambda: step(params, opt, prep.scene, prep.packed.arrays, target,
                                      consts=consts), med, workload, 3)
    return {"workload": workload, "size": size, "triangles": prep.scene.num_faces,
            "metric": "train_step_mrays_per_s_nefertiti", "value": rays / sec / 1e6,
            "value_median": rays / med / 1e6, "unit": "Mrays/s (fwd+bwd, 2 rays a pixel)",
            "seconds_per_step": sec, "seconds_per_step_median": med, "secs_chains": chains,
            "steps_per_chain": TRAIN_STEPS, "first_step_s": first_s,
            "trainable": list(TRAINABLE), "launches_per_step": launches,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "device_kernels_per_step": prof["device_kernels"],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "top_device_ms": prof["top_device_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default=",".join(ROWS), help="comma list of " + ",".join(ROWS))
    ap.add_argument("--repeat", type=int, default=8, help="frames a timed chain")
    ap.add_argument("--rounds", type=int, default=3, help="timed chains a row")
    args = ap.parse_args(argv)
    rows = [r for r in args.rows.split(",") if r]
    unknown = [r for r in rows if r not in SUITE]
    if unknown:
        ap.error(f"unknown rows {unknown}")
    if not torch.cuda.is_available():
        log("bench_torch: no CUDA device")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
    from ray_tracer_tpu_torch.render.renderer import frame_setup, prepare
    from ray_tracer_tpu_torch.tools.profiling import card_line

    card = card_line()
    log(f"card: {card}")
    out = []
    nef = None  # the nefertiti rows share one scene and grid; only the camera differs
    for workload in rows:
        cfg = row_config(workload)
        t0 = time.perf_counter()
        if SUITE[workload][0] != "nefertiti":
            prep = prepare(cfg)
        elif nef is None:
            scene, _ = nefertiti_scene()
            prep = nef = prepare(cfg, scene=scene)
        else:
            prep = nef._replace(cfg=cfg, setup=frame_setup(cfg, nef.scene, nef.packed))
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        if workload == "train_nefertiti_1024":
            row = bench_train(workload, prep, max(args.rounds, 1))
        else:
            row = bench_row(workload, prep, max(args.repeat, 2), max(args.rounds, 1))
        row.update(prepare_s=prep_s, card=card, device=torch.cuda.get_device_name(0))
        print(json.dumps(row), flush=True)
        out.append(row)
    print(json.dumps({"rows": out, "card": card, "device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
