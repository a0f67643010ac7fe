"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result's line."""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import torch

from raybench.harness import cells, checks, peaks
from raybench.harness.port import Fit, Frames, perturbation
from raybench.harness.trace import breakdown, traced

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracer_tpu")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (the part before the first dot,
    compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _load_launchers(libraries: list, split: dict) -> None:
    """Build (all nvcc processes at once) and load the kernel libraries
    that this cell's traffic file names: only what its requests need."""
    from ray_tracer_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(libraries)
    for name in libraries:
        _build.library(name)
    split["launchers_s"] = time.perf_counter() - t0


def _window(call, seconds: float):
    """Closed loop for `seconds`: each call returns once its result is
    complete.  Returns (window seconds, each call's seconds)."""
    times = []
    t0 = time.perf_counter()
    end = t0
    while end - t0 < seconds or not times:
        a = time.perf_counter()
        call()
        end = time.perf_counter()
        times.append(end - a)
    return end - t0, times


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", size: int = None, trace_calls: int = None,
             imports_s: float = None, out=None) -> int:
    """Run the cell and print its result's line to `out` (stdout).
    Returns the exit code."""
    out = sys.stdout if out is None else out
    cell = cells.load_cell(workload)
    traffic = cell.traffic
    size = int(size or traffic["size"])
    split = {"imports_s": imports_s}
    t0 = time.perf_counter()
    import ray_tracer_tpu_torch.opt.fit  # noqa: F401  the program's modules
    import ray_tracer_tpu_torch.render.renderer  # noqa: F401
    split["imports_s"] = (imports_s or 0.0) + time.perf_counter() - t0
    cuda = device == "cuda"
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.empty((1,), device=device)
        torch.cuda.synchronize()
    split["context_s"] = time.perf_counter() - t0
    if cuda:
        _load_launchers(list(traffic["libraries"]), split)
    mode = traffic["mode"]
    if mode == "frames":
        driver = Frames(cell.config, traffic, size, device, split)
    elif mode == "fit":
        driver = Fit(cell.config, traffic, size, device, split, seed)
    else:
        raise ValueError(f"unknown traffic mode {mode!r}")
    setup_s = time.perf_counter() - t_start
    if cuda:
        from ray_tracer_tpu_torch.kernels import _build
        split["libraries_loaded"] = sorted(_build._LOADED)
    log("setup", json.dumps(split))

    tr = None
    if trace:
        tr = traced(driver.call, int(trace_calls or traffic["trace_calls"]))
        window_s, times = tr.window_s, tr.wall_s
    else:
        window_s, times = _window(driver.call, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    q = sorted(times)
    log("calls", json.dumps({"n": len(q), "window_s": window_s, "min": q[0], "median": q[len(q) // 2],
                             "max": q[-1]}))

    # what the timed path produced, then the program's state freed
    if mode == "frames":
        pixels = checks.sample_pixels(seed, size * size, int(traffic["check"]["pixels"]),
                                      driver.image.device)
        answer = driver.answer()[pixels].float().cpu()
        failed = 0
    else:
        prog = {"losses": driver.losses, "first_grad": driver.first_grad,
                "change": driver.change}
        failed = driver.failed
        n_verts = driver.prep.scene.verts.shape[0]
        n_mats = driver.prep.scene.materials.kd.shape[0]
    driver.free()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    if mode == "frames":
        numbers = checks.frame_numbers(cell.config, traffic, size, pixels.to(device), answer)
    else:
        delta = perturbation(traffic, n_verts, n_mats, seed, device)
        ref = checks.reference_fit_record(cell.config, traffic, size, delta, device)
        numbers = checks.fit_numbers(prog, ref)
        log("fit", json.dumps({"program": prog, "reference": ref}))
    ref_s = time.perf_counter() - t0
    # a number that is not finite (a NaN loss, say) fails its limit
    correct = bool(numbers) and all(
        k in cell.limits and math.isfinite(v) and v <= cell.limits[k]["limit"]
        for k, v in numbers.items())

    run = {"workload": workload, "mode": mode, "size": size, "calls": len(times),
           "window_s": window_s, "times": times, "setup_s": setup_s, "split": split,
           "trace": tr, "work": cells.work_counts(workload), "peaks": peaks.H100,
           "device": device}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(m["name"])(run)
        if cuda and value is not None:  # a CPU run reports no metric
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": correct, "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
    result["setup_split"] = {**split, "setup_s": setup_s, "reference_s": ref_s}
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": cell.limits.get(k, {}).get("limit")}
                        for k, v in numbers.items()}
    # the last step before the result: nothing may have loaded JAX or the
    # JAX package after the window, the reference and the readers included
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), file=out, flush=True)
    return 0
