"""The card's name and power limit, and a render's device profile, as the
port's bench and its card check report them (CUDA only)."""

from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def profiled_kernels(fn, n: int, attempts: int = 3):
    """The device kernels of n calls of fn() under torch.profiler (CUDA
    activity), after a warm-up.  A window in which the profiler saw no
    kernel is taken again, up to `attempts` windows (the profiler can
    return a window empty or short).  Returns (kernel events,
    windows taken)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)  # let the tracer take the window's last records
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if kernels:
            break
    return kernels, attempt


def profile_render(prep, median_s: float, config: str, frames: int = 10) -> dict:
    """`frames` renders in one torch.profiler window: a frame's device
    kernels, its device busy time (the sum of kernel durations; kernels on
    one stream do not overlap), the idle share of the unprofiled median
    frame time that leaves, the device time by kernel name, and each
    kernel's launches a frame.  The profiler can drop a few of a window's
    events, so a kernel's launches a frame are the ceiling of its events
    over the frames, each at its mean duration."""
    from ray_tracer_tpu_torch.render.renderer import render

    kernels, windows = profiled_kernels(lambda: render(prep), frames)
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    per_frame = {k: (-(-len(v) // frames), sum(v) / len(v)) for k, v in by_name.items()}
    busy_us = sum(n * us for n, us in per_frame.values())
    top = sorted(per_frame.items(), key=lambda kv: -kv[1][0] * kv[1][1])[:6]
    return {"phase": "main_path_profile", "config": config,
            "device_kernels": sum(n for n, _ in per_frame.values()), "frames": frames,
            "kernel_events_seen": len(kernels), "profile_windows": windows,
            "device_busy_ms": busy_us / 1e3, "median_frame_ms": median_s * 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / (median_s * 1e3),
            "top_device_ms": {k[:60]: n * us / 1e3 for k, (n, us) in top},
            "kernels_per_frame": {k[:80]: n for k, (n, _) in per_frame.items()}}
