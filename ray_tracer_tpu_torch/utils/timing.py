"""Timing, throughput reporting, profiling hooks and the port's spans.

Counterpart of `ray_tracer_tpu/utils/timing.py` on CUDA: `time_fn` and
`measure_mrays` time the card's work with CUDA events around each call
(the host's clock fenced by `hard_sync` on the CPU); `profile_trace`
records a torch.profiler trace of the CPU and the card.

The port's spans and counters: `part(name)` marks a span of its host
path (`rt.render`, `rt.fit.step` and the spans inside them, `prepare`'s
parts), `count(name, n)` a counter (`rt.sync.<site>`: the host-device
synchronisations the port makes inside a frame or a step).  Both are off
unless a torch profiler is recording or a recorder (`recording`,
`split_parts`) is open: a span is then one check that returns a shared
no-op context, a counter one check.  On, a span opens a host-only
profiler range (`_RecordFunctionFast`: a host event that is no user
annotation, so the profiler mirrors nothing onto the device's timeline)
and, as it ends, appends a `Span` to the innermost open recorder, or,
with none open, to the profiled log (`profiled()`) that the benchmark's
readers take after a traced window; a counter adds to its name under the
call of the innermost open span.  Times are the profiler's clock: Unix
nanoseconds, as its host events.  The spans of one thread nest; the
port's host path runs on one.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _range


def hard_sync(x=None) -> None:
    """Wait for the card's queued work: every CUDA device synchronises when
    CUDA is up (x is taken for the JAX signature, whose sync fences a
    result's arrays); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


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


# ---- spans and counters ----------------------------------------------------


class Span(NamedTuple):
    """One span: its name, start and end (Unix ns, the profiler's clock),
    the id of the span it ran in (None for an outermost span), the id of
    its outermost span (its call: one a frame or a step), its own id, and
    under `split_parts` the CUDA-event ms between its ends (else None)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int
    id: int
    device_ms: Optional[float] = None


class Recorder:
    """What spans and counters recorded: `spans` in the order they ended,
    `counts` by (call id, name) (call None outside every span).  A fenced
    recorder synchronises the card at each span's ends and times it with
    CUDA events (`split_parts`)."""

    def __init__(self, fenced: bool = False):
        self.spans: list = []
        self.counts: Dict[tuple, int] = {}
        self.fenced = fenced


_RECORDER: Optional[Recorder] = None  # the innermost open recorder
_PROFILED = Recorder()  # where spans go while a profiler records and no recorder is open
_OPEN = None  # the innermost open span (_On), if any
_IDS = itertools.count()


def profiled() -> Recorder:
    """The spans and counts recorded while a torch profiler was recording
    and no recorder was open, in this process."""
    return _PROFILED


@contextlib.contextmanager
def _opened(rec: Recorder):
    global _RECORDER
    prev, _RECORDER = _RECORDER, rec
    try:
        yield rec
    finally:
        _RECORDER = prev


def recording():
    """Record the spans and counters of the block: yields its Recorder."""
    return _opened(Recorder())


@contextlib.contextmanager
def split_parts():
    """Record the parts of the calls made inside the block, fenced: yields
    a list that gets (name, host seconds, device ms) for each part in the
    order they ended.  A part starts and ends with a device
    synchronisation, so its host seconds hold the card work it queued;
    its device ms are CUDA events between its start and end (None
    without a card)."""
    rows = []
    with _opened(Recorder(fenced=True)) as rec:
        try:
            yield rows
        finally:
            rows.extend((s.name, (s.end_ns - s.start_ns) / 1e9, s.device_ms)
                        for s in rec.spans)


class _Off:
    """The span while nothing records: one shared object, no work."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _On:
    """A recorded span: a host-only profiler range and a Span record."""

    __slots__ = ("name", "rec", "rng", "up", "call", "id", "t0", "ev")

    def __init__(self, name: str, rec: Recorder):
        self.name = name
        self.rec = rec

    def __enter__(self):
        global _OPEN
        self.id = next(_IDS)
        self.up = _OPEN
        self.call = self.id if _OPEN is None else _OPEN.call
        _OPEN = self
        self.ev = None
        if self.rec.fenced and torch.cuda.is_available() and torch.cuda.is_initialized():
            hard_sync()
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.rng = _range(self.name)
        self.rng.__enter__()
        self.t0 = time.time_ns()
        return None

    def __exit__(self, *exc):
        global _OPEN
        self.rng.__exit__(*exc)
        dev_ms = None
        if self.ev is not None:
            self.ev[1].record()
            hard_sync()
            dev_ms = self.ev[0].elapsed_time(self.ev[1])
        t1 = time.time_ns()
        _OPEN = self.up
        self.rec.spans.append(Span(self.name, self.t0, t1,
                                   None if self.up is None else self.up.id, self.call,
                                   self.id, dev_ms))
        return None


def part(name: str):
    """A span of the port's host path, named `rt.<layer>.<part>`: a
    context that records when a profiler records or a recorder is open,
    else the shared no-op."""
    rec = _RECORDER
    if rec is None:
        if not _profiler._is_profiler_enabled:
            return _OFF
        rec = _PROFILED
    return _On(name, rec)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` under the innermost open span's call, when
    a profiler records or a recorder is open."""
    rec = _RECORDER
    if rec is None:
        if not _profiler._is_profiler_enabled:
            return
        rec = _PROFILED
    key = (None if _OPEN is None else _OPEN.call, name)
    rec.counts[key] = rec.counts.get(key, 0) + n
