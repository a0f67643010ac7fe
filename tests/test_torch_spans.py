"""The port's spans and counters (utils/timing.part, count, recording,
split_parts, profiled) on the CPU:

* a tiny render and a tiny fit step record their spans, nested, one call
  id per outermost span (`rt.render`, `rt.fit.step`);
* with nothing recording, a span is the shared no-op: nothing is
  recorded and no profiler range, CUDA event or sync is made;
* under a CPU torch.profiler every `rt.` event is a host event and no
  user annotation, and the spans land in the profiled log;
* split_parts still yields prepare's (name, host seconds, device ms)
  rows;
* a counter counts under the call id of the innermost open span.
"""

import dataclasses

import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt import fit  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402
from ray_tracer_tpu_torch.utils import timing  # noqa: E402

SIZE = 8
FIT_SPANS = {"rt.fit.tables", "rt.fit.forward", "rt.fit.backward", "rt.fit.adam"}


@pytest.fixture(scope="module")
def prep():
    scene, cfg = scenes.gradcheck_scene(SIZE, SIZE, device="cpu")
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, ray_tile=64))
    return prepare(cfg, scene=scene)


def _frame_and_step(prep):
    img = render(prep)
    step, init = fit.make_train_step(prep.grid.meta, prep.cfg, lr=1e-2, trainable=("kd",))
    params, opt = init(fit.split_scene(prep.scene))
    step(params, opt, prep.scene, prep.grid.arrays, img)
    return img


def test_render_and_fit_step_record_nested_spans(prep):
    with timing.recording() as rec:
        _frame_and_step(prep)
    outer = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in outer] == ["rt.render", "rt.fit.step"]
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert s.call in {o.id for o in outer}
        assert s.start_ns <= s.end_ns
        if s.parent is not None:  # nested inside its parent, in the same call
            up = by_id[s.parent]
            assert up.call == s.call and up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    frame, step = outer
    frame_names = {s.name for s in rec.spans if s.call == frame.id and s is not frame}
    assert frame_names == {"rt.render.camera", "rt.render.trace", "rt.render.shade"}
    depth = [s for s in rec.spans if s.call == frame.id and s.parent == frame.id]
    assert [s.name for s in depth if s.name != "rt.render.camera"] == \
        ["rt.render.trace", "rt.render.shade"] * (prep.cfg.render.max_bounces + 1)
    step_children = {s.name for s in rec.spans if s.parent == step.id}
    assert step_children == FIT_SPANS
    forward = next(s for s in rec.spans if s.name == "rt.fit.forward")
    assert {s.name for s in rec.spans if s.parent == forward.id} >= {
        "rt.render.camera", "rt.render.trace", "rt.render.shade"}


def test_off_records_nothing_and_calls_no_profiler(prep, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span with nothing recording reached the profiler")

    monkeypatch.setattr(timing, "_range", boom)
    monkeypatch.setattr(timing, "hard_sync", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    before = (len(timing.profiled().spans), dict(timing.profiled().counts))
    assert timing.part("rt.render") is timing.part("rt.fit.step") is timing._OFF
    _frame_and_step(prep)
    timing.count("rt.sync.test")
    assert (len(timing.profiled().spans), timing.profiled().counts) == before


def test_profiler_sees_host_only_spans(prep):
    from torch.profiler import ProfilerActivity, profile

    n0 = len(timing.profiled().spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(prep)
    ours = [e for e in prof.events() if e.name.startswith("rt.")]
    assert {e.name for e in ours} == {"rt.render", "rt.render.camera", "rt.render.trace",
                                      "rt.render.shade"}
    assert all(e.device_type.name == "CPU" and not e.is_user_annotation for e in ours)
    got = timing.profiled().spans[n0:]
    assert sorted(s.name for s in got) == sorted(e.name for e in ours)


def test_split_parts_rows(prep):
    with timing.split_parts() as rows:
        prepare(prep.cfg, scene=prep.scene)
    names = [r[0] for r in rows]
    assert names[:1] == ["rt.prepare.scene"] and "rt.prepare.build_grid" in names
    assert {"rt.grid.H", "rt.grid.assemble", "rt.prepare.frame_setup"} <= set(names)
    assert names.index("rt.grid.H") < names.index("rt.prepare.build_grid")  # ended first
    for name, host_s, dev_ms in rows:
        assert isinstance(name, str) and host_s >= 0.0 and dev_ms is None  # no card


def test_counter_counts_under_its_call():
    with timing.recording() as rec:
        timing.count("rt.sync.outside")
        with timing.part("rt.a"):
            timing.count("rt.sync.x", 2)
            with timing.part("rt.a.b"):
                timing.count("rt.sync.x")
        with timing.part("rt.c"):
            timing.count("rt.sync.x", 5)
    a, c = (s for s in rec.spans if s.parent is None)
    assert rec.counts == {(None, "rt.sync.outside"): 1, (a.id, "rt.sync.x"): 3,
                          (c.id, "rt.sync.x"): 5}
