"""The traced window: closed-loop calls under torch.profiler, read into
what the metric readers take.

`busy_s` is the union of the device's operations (kernels, copies,
sets) in the window, `window_s` the window's wall time on the host's
clock, from the first call to the device's last operation.  Kernels are
kept by name with their durations; the idle gaps between device
operations are named by the innermost host operation open at the gap's
middle ("host_idle" where none is)."""

from __future__ import annotations

import bisect
import time
from typing import NamedTuple

import torch

WINDOW = "raybench.window"


class Trace(NamedTuple):
    calls: int
    window_s: float
    busy_s: float
    kernels: list  # [(name, seconds)], one entry a launch, in launch order
    gaps: list  # [(host op, seconds)], longest first
    wall_s: list  # each call's host seconds


def _device(e) -> bool:
    """A device operation (the window's own annotation, which the
    profiler also records on the device's timeline, left out)."""
    return e.device_type.name == "CUDA" and e.name != WINDOW


def traced(call, calls: int) -> Trace:
    """Two windows of closed-loop calls: `calls` under the device's
    activity alone, which give the busy time, the window and the kernels;
    then a quarter as many with the host's operations too, which only name
    the idle gaps (tracing the host's operations slows it, and would
    inflate the idle share)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    walls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            a = time.perf_counter()
            call()
            walls.append(time.perf_counter() - a)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev = sorted((e for e in prof.events() if _device(e)), key=lambda e: e.time_range.start)
    busy = sum(b - a for a, b in _union(dev))
    kernels = [(e.name, (e.time_range.end - e.time_range.start) / 1e6) for e in dev]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(max(2, calls // 4)):
                call()
            torch.cuda.synchronize()
    return Trace(calls=calls, window_s=window, busy_s=busy / 1e6, kernels=kernels,
                 gaps=_named_gaps(prof.events()), wall_s=walls)


def _union(dev, lo=float("-inf"), hi=float("inf")):
    """The device's busy intervals: its operations' spans merged."""
    spans = []
    for e in dev:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b <= a:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    return spans


def _named_gaps(events) -> list:
    """The ten longest gaps between device operations in the window, each
    named by the innermost host operation open at its middle."""
    win = next(e for e in events if e.name == WINDOW and e.device_type.name == "CPU")
    w0, w1 = win.time_range.start, win.time_range.end
    spans = _union(sorted((e for e in events if _device(e)),
                          key=lambda e: e.time_range.start), w0, w1)
    host = [e for e in events if e.device_type.name == "CPU" and e.name != WINDOW
            and w0 <= e.time_range.start <= w1]
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps = [(b0 - a1, (a1 + b0) / 2) for (_, a1), (b0, _) in zip(spans, spans[1:])]
    if spans:
        gaps.append((spans[0][0] - w0, (w0 + spans[0][0]) / 2))
    gaps.sort(key=lambda g: -g[0])
    named = []
    for length, mid in gaps[:10]:
        best = None
        for e in host[:bisect.bisect_right(starts, mid)]:
            if e.time_range.end >= mid and (best is None or
                                            e.time_range.elapsed_us() < best.time_range.elapsed_us()):
                best = e
        named.append(("host_idle" if best is None else best.name, length / 1e6))
    return named


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time over the window and
    the ten longest idle gaps, each [name, seconds]."""
    by = {}
    for name, s in trace.kernels:
        by[name] = by.get(name, 0.0) + s
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k[:120], v] for k, v in trace.gaps]}
