"""The readers of the program's spans and counters (`harness/spans.py`,
`metrics/host_ms.*`, `epilogue_host_ms.frame`, `backward_host_ms.step`,
`syncs.*`) on a made-up run: each reads the first `trace.calls` calls
alone, in its own mode; an untraced run, a CPU run and a program that
keeps no spans give None."""

import pytest

from raybench.harness import cells, spans
from raybench.harness.trace import Trace
from ray_tracer_tpu_torch.utils.timing import Recorder, Span

MS = 1_000_000  # ns


def _frames(rec, n, start, ms, shade_ms, trace_ms, syncs):
    """n made-up frames from `start` ms: rt.render of `ms`, holding a
    trace of `trace_ms` and then a shade of `shade_ms` that holds a
    shadow trace of 1 ms; `syncs` counted a frame."""
    ids = iter(range(len(rec.spans), 10**9))
    for k in range(n):
        t = (start + k * 100) * MS
        f = next(ids)
        tr, sh, st = next(ids), next(ids), next(ids)
        rec.spans += [Span("rt.render.trace", t, t + trace_ms * MS, f, f, tr),
                      Span("rt.render.trace", t + (trace_ms + 1) * MS,
                           t + (trace_ms + 2) * MS, sh, f, st),
                      Span("rt.render.shade", t + trace_ms * MS,
                           t + (trace_ms + shade_ms) * MS, f, f, sh),
                      Span("rt.render", t, t + ms * MS, None, f, f)]
        rec.counts[(f, "rt.sync.camera_basis")] = syncs
        rec.counts[(f, "other")] = 7


def _steps(rec, n, start, ms, backward_ms, syncs):
    ids = iter(range(len(rec.spans), 10**9))
    for k in range(n):
        t = (start + k * 100) * MS
        s, b = next(ids), next(ids)
        rec.spans += [Span("rt.fit.backward", t + MS, t + (1 + backward_ms) * MS, s, s, b),
                      Span("rt.fit.step", t, t + ms * MS, None, s, s)]
        rec.counts[(s, "rt.sync.launch_light")] = syncs


def _run(mode, calls=4, device="cuda", trace=True):
    tr = Trace(calls=calls, window_s=1.0, busy_s=0.5, kernels=[], gaps=[], wall_s=[])
    return {"mode": mode, "device": device, "trace": tr if trace else None}


@pytest.fixture
def recorded(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(spans, "_recorded", lambda: rec)
    return rec


def test_frame_readers_take_the_first_window(recorded):
    _frames(recorded, 4, 0, ms=2, shade_ms=5, trace_ms=3, syncs=3)
    # the host-traced window after it: slower, more syncs
    _frames(recorded, 2, 1000, ms=9, shade_ms=9, trace_ms=4, syncs=50)
    run = _run("frames")
    read = {m: cells.reader(m)(run) for m in ("host_ms.frame", "epilogue_host_ms.frame",
                                              "syncs.frame", "host_ms.step", "syncs.step",
                                              "backward_host_ms.step")}
    assert read["host_ms.frame"] == pytest.approx(2.0)
    assert read["epilogue_host_ms.frame"] == pytest.approx(4.0)  # 5 less the 1 ms trace
    assert read["syncs.frame"] == 3.0
    assert read["host_ms.step"] is None and read["syncs.step"] is None
    assert read["backward_host_ms.step"] is None


def test_step_readers_take_the_first_window(recorded):
    _steps(recorded, 3, 0, ms=50, backward_ms=20, syncs=2)
    _steps(recorded, 1, 1000, ms=80, backward_ms=40, syncs=9)
    run = _run("fit", calls=3)
    assert cells.reader("host_ms.step")(run) == pytest.approx(50.0)
    assert cells.reader("backward_host_ms.step")(run) == pytest.approx(20.0)
    assert cells.reader("syncs.step")(run) == 2.0
    assert cells.reader("host_ms.frame")(run) is None


def test_wave_frames_count_zero_syncs(recorded):
    for k in range(3):
        recorded.spans.append(Span("rt.render", k * MS, k * MS + 100, None, k, k))
    run = _run("frames", calls=3)
    assert cells.reader("syncs.frame")(run) == 0.0
    assert cells.reader("epilogue_host_ms.frame")(run) is None


@pytest.mark.parametrize("how", ["untraced", "cpu", "no spans"])
def test_nothing_to_read(recorded, monkeypatch, how):
    _frames(recorded, 4, 0, ms=2, shade_ms=5, trace_ms=3, syncs=3)
    run = _run("frames", trace=how != "untraced", device="cpu" if how == "cpu" else "cuda")
    if how == "no spans":
        monkeypatch.setattr(spans, "_recorded", lambda: None)
    for m in ("host_ms.frame", "epilogue_host_ms.frame", "syncs.frame"):
        assert cells.reader(m)(run) is None
