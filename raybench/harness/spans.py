"""What the readers of the program's own spans and counters share.

While a torch profiler records, the program keeps a record of each span
of its host path (name, start and end on the profiler's clock, its
parent, and its call: the id of its outermost span, one a frame or a
train step) and adds each counter to its name under its call
(`ray_tracer_tpu_torch.utils.timing.profiled`).  A traced run records
in two windows: `trace.calls` calls under the device's activity alone,
then a quarter as many with the host's operations traced too, which
slows the host.  So a reader takes the first `trace.calls` calls alone.

A reader returns None where there is nothing to read: an untraced run,
no card, or a program that keeps no spans."""

from __future__ import annotations

from raybench.harness.readers import traced


def _recorded():
    """The program's profiled record, or None where it keeps none."""
    try:
        from ray_tracer_tpu_torch.utils.timing import profiled
    except ImportError:
        return None
    return profiled()


def window(run: dict):
    """(spans, counts, n) of the traced run's first window: the spans and
    counts of its first `trace.calls` calls (by their outermost span's
    start) and the number of those calls; None where there is nothing to
    read."""
    tr = traced(run)
    rec = _recorded() if tr is not None else None
    if rec is None:
        return None
    outer = sorted((s for s in rec.spans if s.parent is None), key=lambda s: s.start_ns)
    ids = {s.id for s in outer[:tr.calls]}
    if not ids:
        return None
    spans = [s for s in rec.spans if s.call in ids]
    counts = {k: v for k, v in rec.counts.items() if k[0] in ids}
    return spans, counts, len(ids)


def mean_ms(run: dict, name: str, outer: bool = False):
    """The summed duration of the spans `name` a call of the first window,
    in ms (with `outer`, only outermost spans of that name); None where
    there is none."""
    w = window(run)
    if w is None:
        return None
    spans, _, n = w
    got = [s for s in spans if s.name == name and (not outer or s.parent is None)]
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / n / 1e6


def self_ms(run: dict, name: str):
    """The self time of the spans `name` a call of the first window: each
    one's duration less its child spans', in ms; None where there is
    none."""
    w = window(run)
    if w is None:
        return None
    spans, _, n = w
    got = {s.id: s.end_ns - s.start_ns for s in spans if s.name == name}
    if not got:
        return None
    for s in spans:
        if s.parent in got:
            got[s.parent] -= s.end_ns - s.start_ns
    return sum(got.values()) / n / 1e6


def count_per_call(run: dict, prefix: str):
    """The counters whose name starts with `prefix`, summed a call of the
    first window; None where the window holds no call."""
    w = window(run)
    if w is None:
        return None
    _, counts, n = w
    return sum(v for (_, name), v in counts.items() if name.startswith(prefix)) / n
