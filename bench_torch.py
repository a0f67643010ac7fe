"""The PyTorch/CUDA port's benchmark: the rows of BENCH_SUITE_r05.json on
one NVIDIA card, or bench.py's single measurement.

    python3 bench_torch.py                      # all seven rows
    python3 bench_torch.py --rows gi_spot_1024_s4d2,parallel_1024
    python3 bench_torch.py --rows train_nefertiti_1024
    python3 bench_torch.py --size 1024 --scene spot   # one measurement
    python3 bench_torch.py --gi 4 --gi-depth 2        # path-traced GI
    python3 bench_torch.py --grad                     # one train step
    python3 bench_torch.py --size 16 --device cpu     # the same on the CPU

Run from the repository root on a machine with a CUDA device; without one
it exits 2 before any measurement, unless `--device cpu` asks for the
single measurement on the CPU (the tests do; the rows run on the card
only).  `--suite auto` (the default) runs the rows when the script is
called with none of --scene, --size, --gi and --grad, else the single
measurement, as bench.py:234-239 chooses.

The single measurement follows bench.py's contract: the scene (spot,
nefertiti or parallel) at --size squared with the knobs the rows take
(`scene_config`, and the probes of `probed`), a warm-up frame, then the
best of --rounds chains of --repeat frames (or train steps), each chain
ending with a device sync; one JSON line with bench.py's keys for the
mode (the forward render bench.py:519-533, GI `_bench_gi`, the train step
`_bench_grad`, values rounded to 4 places as there), and beside them
`device` (the card's name) and `card` (its name and power limit), which
bench.py's GI and train-step lines lack.  The forward line's vs_baseline
is the value over the C++ oracle's Mrays/s on this host
(native/build/oracle, run as a subprocess at --oracle-size, the same size
by default); GI and the train step have no counterpart in the oracle
(vs_baseline 0).  As in bench.py the oracle is given the spot scene's
arguments for every scene but parallel, so nefertiti's vs_baseline is
against the spot oracle.  The frame's kernel launches go to stderr
(`launches: {...}`), and on the card the kernel of the mode (ROW_KERNEL,
kernel F for GI) must have launched.

Each row is the JAX package's bench.py
row (`SUITE`, bench.py:173-190) with the knobs bench.py derives from
TUNED_KNOBS (bench.py:373-447): the packed grid at the family's row width,
grid resolution and SAT-exact insertion, the persistent wave at its wave
and pump, the Whitted wave's own knee on the parallel scene and gi_pump on
the GI row.  `fused_shadow` and `camera_refill` come from the measured
probes after prepare, as bench.py:459-473 takes them
(`render/metrics.choose_fused_shadow`: on under the persistent scheduler,
else by the coverage probe; `choose_camera_refill`: "on" where at least
45% of the camera rays miss the grid's box, else "off"); each row prints
the picks and the probes' wall time.

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
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

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
SINGLE_TRAINABLE = "base_color,kd,ks,ka,light_pos"  # bench.py --trainable's default
TRAIN_STEPS = 4  # a timed chain of the training row
# the kernel each row's frame must launch (ops wrappers' launch counters)
ROW_KERNEL = {"spot": "packed_march", "nefertiti": "packed_march", "parallel": "whitted_wave"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def row_config(workload: str, size: int = None):
    """The config of a suite row at its size (or `size`), with bench.py's
    knobs from TUNED_KNOBS."""
    name, full, gi, gi_depth = SUITE[workload]
    return scene_config(name, full if size is None else size, gi, gi_depth)


def scene_config(name: str, size: int, gi: int = 0, gi_depth: int = 2, grad: bool = False):
    """Scene `name` (spot, nefertiti or parallel) at size x size with
    bench.py's knobs from TUNED_KNOBS (bench.py:373-447): a train step
    (`grad`) keeps the forward knobs without the Whitted wave's knee."""
    from ray_tracer_tpu_torch.config import TUNED_KNOBS, GridConfig
    from ray_tracer_tpu_torch.models import scenes

    k = TUNED_KNOBS[{"spot": "serial"}.get(name, name)]
    if name == "nefertiti":
        cfg = scenes.nefertiti_scene_config(size, size)
    elif name == "parallel":
        cfg = scenes.parallel_scene_config(size, size)
    else:
        cfg = scenes.serial_scene_config(size, size)
    wave, pump = k["wave"], k["pump"]
    whitted = "auto" if k.get("wwave") else "off"
    if k.get("wwave") and gi == 0 and not grad:  # the Whitted wave's own knee
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


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_chains(call, n: int, rounds: int, device: torch.device, start=None) -> list:
    """Seconds a call of call() in each of `rounds` chains of n calls: CUDA
    events around each chain on the card, the host's clock on the CPU; each
    chain ends with a device sync, and start() (untimed) runs before it."""
    chains = []
    for _ in range(rounds):
        if start is not None:
            start()
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                call()
            b.record()
            torch.cuda.synchronize(device)
            chains.append(a.elapsed_time(b) / n / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            chains.append((time.perf_counter() - t0) / n)
    return chains


def probed(prep):
    """(prep with bench.py's probed knobs, the probes' record):
    fused_shadow from choose_fused_shadow, camera_refill "on" or "off" from
    choose_camera_refill, and the frame facts settled again."""
    from ray_tracer_tpu_torch.render.metrics import choose_camera_refill, choose_fused_shadow
    from ray_tracer_tpu_torch.render.renderer import frame_setup

    t0 = time.perf_counter()
    fused = choose_fused_shadow(prep)
    refill = "on" if choose_camera_refill(prep) else "off"
    sync(prep.device)
    secs = time.perf_counter() - t0
    cfg = dataclasses.replace(prep.cfg, render=dataclasses.replace(
        prep.cfg.render, fused_shadow=fused, camera_refill=refill))
    prep = prep._replace(cfg=cfg, setup=frame_setup(cfg, prep.scene, prep.packed))
    return prep, {"fused_shadow": fused, "camera_refill": refill, "seconds": secs}


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
    chains = timed_chains(lambda: render(prep), repeat, rounds, prep.device)
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
                     "fused_shadow": rc.fused_shadow, "camera_refill": rc.camera_refill}}
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


def train_chains(prep, trainable, n: int, rounds: int, size: int):
    """(seconds a step in each chain, the first step's seconds, its
    launches, a step closure): make_train_step (Adam at lr
    1e-3) against a zero target on the prepared grid, held fixed as fit
    holds it between rebuilds; each chain of n steps from the scene's
    parameters and a fresh optimizer."""
    from ray_tracer_tpu_torch.opt.fit import make_train_step, split_scene

    step, init = make_train_step(prep.packed.meta, prep.cfg, lr=1e-3, trainable=trainable)
    first = split_scene(prep.scene)
    target = torch.zeros((size, size, 3), device=prep.device)
    consts = prep.frame().consts
    state = {}

    def start():
        state["params"], state["opt"] = init(first)

    def call():
        state["params"], state["opt"], state["loss"] = step(
            state["params"], state["opt"], prep.scene, prep.packed.arrays, target,
            consts=consts)

    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    start()
    t0 = time.perf_counter()
    call()
    sync(prep.device)
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if not bool(torch.isfinite(state["loss"])):
        raise AssertionError("non-finite loss")
    chains = timed_chains(call, n, rounds, prep.device, start=start)
    return chains, first_s, launches, call


def bench_train(workload: str, prep, rounds: int) -> dict:
    from ray_tracer_tpu_torch.tools.profiling import profile_calls

    size = SUITE[workload][1]
    torch.cuda.reset_peak_memory_stats()
    chains, first_s, launches, call = train_chains(prep, TRAINABLE, TRAIN_STEPS, rounds, size)
    if launches["packed_march"] <= 0:
        raise AssertionError(f"{workload}: the step launched packed_march 0 times")
    sec = min(chains)
    med = sorted(chains)[len(chains) // 2]
    rays = size * size * 2
    prof = profile_calls(call, med, workload, 3)
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


# ---- bench.py's single measurement ----------------------------------------

def oracle_mrays(size: int, scene: str = "spot") -> float:
    """The C++ oracle's Mrays/s at size x size on this host (2 W H rays a
    frame, as the oracle reports them; --repeat 3), bench.py's
    `oracle_mrays`: native/build/oracle run as a subprocess, built with
    `make -C native` when absent; the parallel scene's arguments for
    "parallel", the spot scene's for every other scene.  A failure is
    logged and gives 0.0 (the measurement goes on)."""
    oracle = os.path.join(REPO, "native", "build", "oracle")
    a = lambda n: os.path.join(REPO, "assets", n)  # noqa: E731
    if scene == "parallel":
        scene_args = [
            "--variant", "parallel", "--camera", "18,18,19", "--fov", "60",
            "--light", "2,5,0",
            "--mesh", a("plane.obj") + ":0,0.4,0:3:0",
            "--mesh", a("blub_triangulated.obj") + ":-2,0,0:5:1",
            "--mesh", a("spot_triangulated.obj") + ":0,0,0:5:1",
            "--mesh", a("blub_triangulated.obj") + ":2,0,0:5:3",
        ]
    else:
        scene_args = ["--mesh", a("spot_triangulated.obj"),
                      "--mesh", a("blub_triangulated.obj") + ":1.5,0,0"]
    try:
        if not os.path.exists(oracle):
            subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-j4"],
                           check=True, capture_output=True, timeout=300)
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run(
                [oracle, "--width", str(size), "--height", str(size),
                 "--out", os.path.join(tmp, "oracle.ppm"), "--repeat", "3"] + scene_args,
                check=True, capture_output=True, timeout=1200, text=True)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        return float(rec["mrays_per_s"])
    except (OSError, subprocess.SubprocessError, ValueError, KeyError, IndexError) as e:
        log(f"oracle baseline unavailable: {e}")
        return 0.0


def frame_chains(prep, args):
    """A warm-up frame (its seconds logged; its shape and finite pixels
    checked), then --rounds chains of --repeat frames -> (best, median,
    chains) in seconds a frame."""
    from ray_tracer_tpu_torch.render.renderer import render

    t0 = time.perf_counter()
    img = render(prep)
    sync(prep.device)
    log(f"first frame (incl. the kernels' build): {time.perf_counter() - t0:.1f}s")
    if img.shape != (args.size, args.size, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image {tuple(img.shape)}")
    chains = timed_chains(lambda: render(prep), max(args.repeat, 2), max(args.rounds, 1),
                          prep.device)
    return min(chains), sorted(chains)[len(chains) // 2], chains


def single_forward(prep, args) -> dict:
    """bench.py's forward line (bench.py:486-533)."""
    size = args.size
    sec, med, chains = frame_chains(prep, args)
    rays = size * size * 2  # primary + shadow (BASELINE.md's primary metric)
    mrays = rays / sec / 1e6
    base = oracle_mrays(args.oracle_size or size, args.scene)
    return {"metric": f"mrays_per_s_{args.scene}_primary_shadow", "value": round(mrays, 4),
            "unit": "Mrays/s", "vs_baseline": round(mrays / base if base > 0 else 0.0, 4),
            "seconds_per_frame": round(sec, 4), "value_median": round(rays / med / 1e6, 4),
            "secs_chains": [round(c, 4) for c in chains], "size": size,
            "oracle_mrays_per_s": round(base, 4)}


def single_gi(prep, args) -> dict:
    """bench.py's GI line (`_bench_gi`): path and NEE segments, 2 (depth + 1)
    a path; the oracle has no GI (vs_baseline 0)."""
    size = args.size
    log(f"gi_wave: {prep.cfg.render.gi_wave} -> "
        f"{'wave' if prep.setup.gi_wave else 'segments'}")
    sec, med, chains = frame_chains(prep, args)
    paths = size * size * args.gi
    segments = paths * 2 * (args.gi_depth + 1)
    return {"metric": f"gi_mrays_per_s_{args.scene}", "value": round(segments / sec / 1e6, 4),
            "unit": "Mrays/s (path+NEE segments)", "vs_baseline": 0.0,
            "seconds_per_frame": round(sec, 4), "secs_chains": [round(c, 4) for c in chains],
            "size": size, "gi_samples": args.gi, "gi_depth": args.gi_depth,
            "paths_per_s_m": round(paths / sec / 1e6, 4),
            "paths_per_s_m_median": round(paths / med / 1e6, 4)}


def single_grad(prep, args) -> dict:
    """bench.py's train-step line (`_bench_grad`): forward + backward at 2
    rays a pixel; the oracle has no backward pass (vs_baseline 0)."""
    trainable = tuple(f.strip() for f in args.trainable.split(",") if f.strip())
    chains, first_s, _, _ = train_chains(prep, trainable, max(args.repeat, 2),
                                         max(args.rounds, 1), args.size)
    log(f"first train step (incl. the kernels' build): {first_s:.1f}s")
    sec = min(chains)
    return {"metric": f"train_step_mrays_per_s_{args.scene}",
            "value": round(args.size * args.size * 2 / sec / 1e6, 4),
            "unit": "Mrays/s (fwd+bwd)", "vs_baseline": 0.0, "seconds_per_step": round(sec, 4),
            "size": args.size, "trainable": list(trainable)}


def single(args) -> dict:
    """The single measurement's line: prepare and probe the scene, then the
    mode's measurement on args.device, its kernel's launches checked on the
    card."""
    from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
    from ray_tracer_tpu_torch.render.renderer import prepare
    from ray_tracer_tpu_torch.tools.profiling import card_line

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = card_line() if cuda else None
    if card:
        log(f"card: {card}")
    cfg = scene_config(args.scene, args.size, args.gi, args.gi_depth, grad=args.grad)
    t0 = time.perf_counter()
    scene = (nefertiti_scene(args.size, args.size, device=dev)[0]
             if args.scene == "nefertiti" else None)
    prep = prepare(cfg, scene=scene, device=dev)
    sync(dev)
    log(f"prepare: {time.perf_counter() - t0:.2f}s; scene: {args.scene} "
        f"{prep.scene.num_faces} tris @ {args.size}x{args.size}")
    prep, probes = probed(prep)
    log(f"probes: {probes}")
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    if args.grad:
        line, kernel = single_grad(prep, args), "packed_march"
    elif args.gi > 0:
        line, kernel = single_gi(prep, args), "gi_wave"
    else:
        line, kernel = single_forward(prep, args), ROW_KERNEL[args.scene]
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"launches: {json.dumps(launches)}")
    if cuda and launches[kernel] <= 0:
        raise AssertionError(f"the measurement launched {kernel} 0 times ({launches})")
    line.update(device=torch.cuda.get_device_name(dev) if cuda else "cpu", card=card)
    return line


def parse_args(argv=None):
    """The options; args.suite is resolved to True (the rows) or False
    (the single measurement)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", default="auto", choices=["auto", "on", "off"],
                    help="the rows ('on') or one measurement ('off'); 'auto': the rows "
                         "unless --scene, --size, --gi or --grad is given")
    ap.add_argument("--rows", default=",".join(ROWS), help="comma list of " + ",".join(ROWS))
    ap.add_argument("--repeat", type=int, default=8, help="frames (or steps) a timed chain")
    ap.add_argument("--rounds", type=int, default=3, help="timed chains")
    ap.add_argument("--size", type=int, default=None, help="render size (default 1024)")
    ap.add_argument("--scene", default=None, choices=["spot", "nefertiti", "parallel"],
                    help="the single measurement's scene (default spot)")
    ap.add_argument("--gi", type=int, default=0, metavar="SAMPLES",
                    help="measure path-traced GI at this many samples a pixel")
    ap.add_argument("--gi-depth", type=int, default=2, help="GI bounces (with --gi)")
    ap.add_argument("--grad", action="store_true",
                    help="measure one forward + backward train step")
    ap.add_argument("--trainable", default=SINGLE_TRAINABLE,
                    help="comma list of SceneParams fields differentiated with --grad")
    ap.add_argument("--oracle-size", type=int, default=None,
                    help="the oracle baseline's size (default --size)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) or cpu (the single measurement only)")
    args = ap.parse_args(argv)
    args.suite = args.suite == "on" or (
        args.suite == "auto" and args.scene is None and args.size is None and args.gi == 0
        and not args.grad)
    if args.suite and args.device != "cuda":
        ap.error("the rows run on the card only (--device cuda)")
    args.scene = args.scene or "spot"
    args.size = args.size or 1024
    args.rows = [r for r in args.rows.split(",") if r]
    unknown = [r for r in args.rows if r not in SUITE]
    if unknown:
        ap.error(f"unknown rows {unknown}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log("bench_torch: no CUDA device")
        return 2
    sys.path.insert(0, REPO)
    if not args.suite:
        print(json.dumps(single(args)), flush=True)
        return 0
    from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
    from ray_tracer_tpu_torch.render.renderer import frame_setup, prepare
    from ray_tracer_tpu_torch.tools.profiling import card_line

    card = card_line()
    log(f"card: {card}")
    out = []
    nef = None  # the nefertiti rows share one scene and grid; only the camera differs
    for workload in args.rows:
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
        prep, probes = probed(prep)
        log(f"{workload}: probes {probes}")
        if workload == "train_nefertiti_1024":
            row = bench_train(workload, prep, max(args.rounds, 1))
        else:
            row = bench_row(workload, prep, max(args.repeat, 2), max(args.rounds, 1))
        row.update(prepare_s=prep_s, probes=probes, card=card,
                   device=torch.cuda.get_device_name(0))
        print(json.dumps(row), flush=True)
        out.append(row)
    print(json.dumps({"rows": out, "card": card, "device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
