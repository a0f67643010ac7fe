"""The PyTorch/CUDA port's benchmark: the rows of BENCH_SUITE_r05.json on
one NVIDIA card, or bench.py's single measurement.

    python3 bench_torch.py                      # all seven rows
    python3 bench_torch.py --rows gi_spot_1024_s4d2,parallel_1024
    python3 bench_torch.py --rows train_nefertiti_1024
    python3 bench_torch.py --size 1024 --scene spot   # one measurement
    python3 bench_torch.py --gi 4 --gi-depth 2        # path-traced GI
    python3 bench_torch.py --grad                     # one train step
    python3 bench_torch.py --size 16 --device cpu     # the same on the CPU
    python3 bench_torch.py --size 1024 --layout blocks --fused off  # knobs pinned

Run from the repository root on a machine with a CUDA device; without one
it exits 2 before any measurement, unless `--device cpu` asks for the
single measurement on the CPU (the tests do; the rows run on the card
only).  On the card a child process first starts CUDA under
--probe-timeout seconds (bench.py's probe: a card that is present but
hangs or fails at start-up prints bench.py's error line and exits 1).
`--suite auto` (the default) runs the rows when the script is called
with none of --scene, --size, --gi and --grad, else the single
measurement, as bench.py:234-239 chooses.

The single measurement follows bench.py's contract: the scene (spot,
nefertiti or parallel) at --size squared with the knobs the rows take
(`scene_config`, and the probes of `probed`) unless bench.py's knob flags
pin them (--scheduler, --wave, --pump, --block-tris, --layout, --rm,
--max-res, --probe-chain, --order, --exact, --fused, --whitted-wave,
--gi-wave; resolved as bench.py:373-406 does), a warm-up frame, then the
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
(`launches: {...}`), and on the card the kernel of the resolved frame
must have launched: E for the Whitted wave, F for the GI wave, else C
(and F not at all under the segment integrator).

Each row runs in its own subprocess under --suite-timeout seconds, as
bench.py's do: a row that fails or hangs becomes an error row and the
others still print.  Each row is the JAX package's bench.py row (`SUITE`,
bench.py:173-190), which takes no knob flag, with the knobs bench.py
derives from TUNED_KNOBS (bench.py:373-447): the packed grid at the
family's row width, grid resolution and SAT-exact insertion, the
persistent wave at its wave and pump, the Whitted wave's own knee on the
parallel scene and gi_pump on the GI row.  `fused_shadow` and
`camera_refill` come from the measured probes after prepare, as
bench.py:459-473 takes them
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


# bench.py's knob overrides (bench.py:263-308) as parse_args leaves them
# when none is given: None takes the TUNED_KNOBS value
KNOB_DEFAULTS = {"scheduler": "persistent", "wave": None, "pump": None, "block_tris": None,
                 "layout": "auto", "rm": None, "max_res": None, "probe_chain": None,
                 "order": None, "exact": None, "whitted_wave": None, "gi_wave": "auto"}


def knobs_of(args) -> dict:
    """The knob overrides of parsed options (KNOB_DEFAULTS' names)."""
    return {name: getattr(args, name) for name in KNOB_DEFAULTS}


def scene_config(name: str, size: int, gi: int = 0, gi_depth: int = 2, grad: bool = False,
                 knobs: dict = None):
    """Scene `name` (spot, nefertiti or parallel) at size x size with
    bench.py's knobs: each of `knobs` (KNOB_DEFAULTS' names, bench.py's
    overrides) that is given, else its TUNED_KNOBS value, resolved as
    bench.py:373-406 resolves them.  The Whitted wave's own wave and pump
    knee applies to a forward render of a wave scene whose whitted_wave is
    not "off", and GI's pump knee to a GI render, each only where --wave /
    --pump were not given; a train step (`grad`) keeps the forward knobs
    without the Whitted wave's knee.  fused_shadow and camera_refill are
    the probes' (`probed`)."""
    from ray_tracer_tpu_torch.config import TUNED_KNOBS, GridConfig
    from ray_tracer_tpu_torch.models import scenes

    k = TUNED_KNOBS[{"spot": "serial"}.get(name, name)]
    o = dict(KNOB_DEFAULTS, **(knobs or {}))

    def pick(knob, tuned):
        return tuned if o[knob] is None else o[knob]

    if name == "nefertiti":
        cfg = scenes.nefertiti_scene_config(size, size)
    elif name == "parallel":
        cfg = scenes.parallel_scene_config(size, size)
    else:
        cfg = scenes.serial_scene_config(size, size)
    wave, pump = pick("wave", k["wave"]), pick("pump", k["pump"])
    whitted = pick("whitted_wave", "auto" if k.get("wwave") else "off")
    if whitted != "off" and k.get("wwave") and gi == 0 and not grad:
        # the Whitted wave's own knee
        wave = pick("wave", k.get("wwave_wave", wave))
        pump = pick("pump", k.get("wwave_pump", pump))
    if gi > 0:  # the GI wave's own pump knee
        pump = pick("pump", k.get("gi_pump", pump))
    exact = k["exact"] if o["exact"] is None else o["exact"] == "on"
    render = dataclasses.replace(
        cfg.render, faithful=False, det_dtype="float32", traversal="packed", ray_tile=768,
        packed_block_tris=pick("block_tris", k["block_tris"]), fused_shadow=True,
        scheduler=o["scheduler"], wave=wave, pump=pump,
        queue_order=pick("order", k.get("order", "fifo")),
        probe_chain=pick("probe_chain", k.get("chain", 1)), grid_layout=o["layout"],
        whitted_wave=whitted,
        grid=GridConfig(resolution_multiplier=pick("rm", k["rm"]),
                        max_resolution=pick("max_res", k["max_res"]), exact_overlap=exact),
    )
    if gi > 0:
        render = dataclasses.replace(render, gi_samples=gi, gi_depth=gi_depth,
                                     gi_wave=o["gi_wave"])
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


def probed(prep, fused: str = "auto"):
    """(prep with bench.py's probed knobs, the probes' record):
    fused_shadow from choose_fused_shadow under fused="auto" ("on" and
    "off" force it, as bench.py's --fused), camera_refill "on" or "off"
    from choose_camera_refill, and the frame facts settled again."""
    from ray_tracer_tpu_torch.render.metrics import choose_camera_refill, choose_fused_shadow
    from ray_tracer_tpu_torch.render.renderer import frame_setup

    t0 = time.perf_counter()
    fused = choose_fused_shadow(prep) if fused == "auto" else fused == "on"
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
    cfg = scene_config(args.scene, args.size, args.gi, args.gi_depth, grad=args.grad,
                       knobs=knobs_of(args))
    t0 = time.perf_counter()
    scene = (nefertiti_scene(args.size, args.size, device=dev)[0]
             if args.scene == "nefertiti" else None)
    prep = prepare(cfg, scene=scene, device=dev)
    sync(dev)
    log(f"prepare: {time.perf_counter() - t0:.2f}s; scene: {args.scene} "
        f"{prep.scene.num_faces} tris @ {args.size}x{args.size}")
    prep, probes = probed(prep, args.fused)
    log(f"probes: {probes}")
    if not args.grad and args.gi == 0:
        log(f"whitted_wave: {cfg.render.whitted_wave} -> "
            f"{'wave' if prep.setup.wave else 'bounce loop'}")
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    # the kernel of the resolved frame: the Whitted wave (E), the GI wave
    # (F), else the march (C: the bounce loop, the segment integrator, the
    # train step)
    if args.grad:
        line, kernel = single_grad(prep, args), "packed_march"
    elif args.gi > 0:
        line = single_gi(prep, args)
        kernel = "gi_wave" if prep.setup.gi_wave else "packed_march"
    else:
        line = single_forward(prep, args)
        kernel = "whitted_wave" if prep.setup.wave else "packed_march"
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"launches: {json.dumps(launches)}")
    if cuda and launches[kernel] <= 0:
        raise AssertionError(f"the measurement launched {kernel} 0 times ({launches})")
    if cuda and args.gi > 0 and not prep.setup.gi_wave and launches["gi_wave"]:
        raise AssertionError(f"the segment integrator launched gi_wave ({launches})")
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
    ap.add_argument("--suite-timeout", type=float, default=1500.0,
                    help="seconds a row's subprocess may take; a row that fails or "
                         "outlives it becomes an error row")
    ap.add_argument("--probe-timeout", type=float,
                    default=float(os.environ.get("BENCH_PROBE_TIMEOUT", 600)),
                    help="seconds to wait for the card to start in a subprocess probe "
                         "before failing fast (0 = skip; no probe with --device cpu)")
    # bench.py's knob overrides; none given: TUNED_KNOBS' value (the rows take no
    # override); the card's kernels size their own launches, so --wave and
    # --pump reach RenderConfig as in the JAX package and shape no launch
    ap.add_argument("--gi-wave", default="auto", choices=["auto", "on", "off"],
                    help="the GI wave (kernel F); 'off' = the segment integrator "
                         "(kernel C a segment) for A/B")
    ap.add_argument("--whitted-wave", default=None, choices=["auto", "on", "off"],
                    help="the cross-depth Whitted wave (kernel E); default: the "
                         "scene's tuned policy ('auto' on the mirror scene, else 'off')")
    ap.add_argument("--scheduler", default="persistent", choices=["tiled", "persistent"])
    ap.add_argument("--wave", type=int, default=None,
                    help="persistent-scheduler lane count (RenderConfig.wave)")
    ap.add_argument("--pump", type=int, default=None,
                    help="persistent march steps a refill round (RenderConfig.pump)")
    ap.add_argument("--block-tris", type=int, default=None,
                    help="triangles a packed block row")
    ap.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                    help="fuse the shadow pass into the primary march ('auto': the probe)")
    ap.add_argument("--layout", default="auto", choices=["auto", "inline", "blocks"],
                    help="packed-grid memory layout")
    ap.add_argument("--rm", type=float, default=None,
                    help="grid resolution multiplier (cells ~ rm * 3*cbrt(N))")
    ap.add_argument("--max-res", type=int, default=None,
                    help="per-axis grid resolution clamp")
    ap.add_argument("--probe-chain", type=int, default=None,
                    help="cell probes a march step for leap-only lanes (blocks layout)")
    ap.add_argument("--order", default=None, choices=["fifo", "chord"],
                    help="persistent work-queue pop order (default: the scene's tuned)")
    ap.add_argument("--exact", default=None, choices=["on", "off"],
                    help="SAT-exact triangle-box grid insertion (default: the scene's tuned)")
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


# the start-up probe's child: the card's context and one kernel
PROBE_SRC = ("import torch\n"
             "torch.zeros(1, device='cuda').add_(1)\n"
             "torch.cuda.synchronize()\n")


def probe_card(timeout: float):
    """Start CUDA in a child process under `timeout` seconds (bench.py:
    325-359 does so for the JAX backend) -> None, or the failure's name."""
    try:
        subprocess.run([sys.executable, "-c", PROBE_SRC], check=True, timeout=timeout,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except (subprocess.TimeoutExpired, subprocess.CalledProcessError) as e:
        return type(e).__name__
    return None


def bench_one_row(workload: str, repeat: int, rounds: int) -> dict:
    """One row measured in this process (prepared, probed, then
    `bench_row` or `bench_train`)."""
    from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
    from ray_tracer_tpu_torch.render.renderer import prepare
    from ray_tracer_tpu_torch.tools.profiling import card_line

    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    scene = nefertiti_scene()[0] if SUITE[workload][0] == "nefertiti" else None
    prep = prepare(row_config(workload), scene=scene)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prep, probes = probed(prep)
    log(f"{workload}: probes {probes}")
    if workload == "train_nefertiti_1024":
        row = bench_train(workload, prep, max(rounds, 1))
    else:
        row = bench_row(workload, prep, max(repeat, 2), max(rounds, 1))
    row.update(prepare_s=prep_s, probes=probes, card=card, device=torch.cuda.get_device_name(0))
    return row


# a row's subprocess: python -c ROW_CHILD WORKLOAD REPEAT ROUNDS prints its line
ROW_CHILD = "import sys, bench_torch; sys.exit(bench_torch.row_child(sys.argv[1:]))"


def row_child(argv) -> int:
    workload, repeat, rounds = argv
    print(json.dumps(bench_one_row(workload, int(repeat), int(rounds))), flush=True)
    return 0


def run_suite(args) -> None:
    """Each row in its own subprocess under --suite-timeout (bench.py:
    190-217): a row that fails or hangs becomes an error row and the
    others still print; then the line that holds them all."""
    from ray_tracer_tpu_torch.tools.profiling import card_line

    rows = []
    for workload in args.rows:
        log(f"suite: {workload} ...")
        try:
            out = subprocess.run(
                [sys.executable, "-c", ROW_CHILD, workload, str(args.repeat), str(args.rounds)],
                cwd=REPO, capture_output=True, text=True, timeout=args.suite_timeout)
            sys.stderr.write(out.stderr)
            row = json.loads((out.stdout or "").strip().splitlines()[-1])
            if out.returncode != 0 and "error" not in row:
                row["error"] = f"rc={out.returncode}"
        except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
            row = {"error": f"{type(e).__name__}: {e}"}
        row["workload"] = workload
        rows.append(row)
        print(json.dumps(row), flush=True)
        log(f"suite: {workload} -> {row.get('value', row.get('error'))}")
    print(json.dumps({"rows": rows, "card": card_line(), "device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log("bench_torch: no CUDA device")
        return 2
    if args.device == "cuda" and args.probe_timeout > 0:
        failed = probe_card(args.probe_timeout)
        if failed:
            log(f"device backend probe failed: {failed}")
            print(json.dumps({"metric": "mrays_per_s", "value": 0.0,
                              "unit": "Mrays/s (primary+shadow)", "vs_baseline": 0.0,
                              "error": "device backend unavailable (init probe "
                                       f"{failed} after {args.probe_timeout:.0f}s)"}),
                  flush=True)
            return 1
    sys.path.insert(0, REPO)
    if not args.suite:
        print(json.dumps(single(args)), flush=True)
        return 0
    run_suite(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
