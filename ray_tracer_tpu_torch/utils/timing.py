"""Timing, throughput reporting and profiling hooks.

Counterpart of `ray_tracer_tpu/utils/timing.py` on CUDA: `Timer` spans
and `time_fn` are wall-clock times fenced by `hard_sync` (a device
synchronisation on the card, nothing on the CPU); `time_fn` and
`measure_mrays` time the card's work with CUDA events around each call;
`profile_trace` records a torch.profiler trace of the CPU and the card.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch


def hard_sync(x=None) -> None:
    """Wait for the card's queued work: every CUDA device synchronises when
    CUDA is up (x is taken for the JAX signature, whose sync fences a
    result's arrays); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@dataclass
class Timer:
    """Wall-clock spans, each fenced by hard_sync when `result` is given."""

    spans: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, result=None):
        start = time.perf_counter()
        yield
        if result is not None:
            hard_sync(result)
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - start


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median seconds of fn(*args) after `warmup` calls: CUDA events around
    each call where there is a card, else the host's clock (hard-synced)."""
    for _ in range(warmup):
        hard_sync(fn(*args))
    times = []
    for _ in range(iters):
        if torch.cuda.is_available():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            hard_sync(fn(*args))
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def measure_mrays(fn: Callable, *args, rays_per_call: float, warmup: int = 1,
                  iters: int = 3) -> Dict[str, float]:
    """Mrays/s of fn(*args) (the caller counts rays_per_call, primary and
    shadow) and per device: one device serves a call."""
    sec = time_fn(fn, *args, warmup=warmup, iters=iters)
    n_dev = 1
    mrays = rays_per_call / sec / 1e6
    return {"seconds": sec, "mrays_per_s": mrays, "mrays_per_s_per_chip": mrays / n_dev,
            "devices": n_dev}


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler over the block, the CPU and (when there is one) the
    card, its Chrome trace written into logdir; a no-op for None."""
    if logdir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        hard_sync()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


# ---- the parts of a host call --------------------------------------------

_PARTS: Optional[list] = None  # the split being recorded, if any


@contextlib.contextmanager
def split_parts():
    """Record the parts (`part`) of the calls made inside the block: yields
    a list that gets (name, host seconds, device ms) for each part in
    order.  A part starts and ends with a device synchronisation, so its
    host seconds hold the card work it queued; its device ms are CUDA
    events between its start and end (None without a card)."""
    global _PARTS
    prev, _PARTS = _PARTS, []
    try:
        yield _PARTS
    finally:
        _PARTS = prev


@contextlib.contextmanager
def part(name: str):
    """A named part of a host call (`prepare`, `build_grid`, `pack_grid`):
    timed when `split_parts` records, else nothing."""
    parts = _PARTS
    if parts is None:
        yield
        return
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        hard_sync()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    yield
    if cuda:
        ev[1].record()
        hard_sync()
    parts.append((name, time.perf_counter() - t0, ev[0].elapsed_time(ev[1]) if cuda else None))
