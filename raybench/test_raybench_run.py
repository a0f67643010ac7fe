"""A run of every cell at a tiny size on the CPU (the harness's look for a
card skipped): a well-formed last line, no device metric, and `correct`
read from the comparison; the same runs with the timed path broken
underneath come out not correct; the control, the reference one
precision down in the program's place, fails each cell's limits; no
module the harness loads is JAX's or the JAX package's, and the
reference loads nothing of the program."""

import io
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from raybench.harness import cells
from raybench.harness.main import run_cell

ROOT = cells.ROOT
WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]
SIZE = {"frames": 40, "fit": 32}
SEED = 2**31 + 4321


def _run(workload, **kw):
    out = io.StringIO()
    size = SIZE[cells.load_cell(workload).traffic["mode"]]
    rc = run_cell(workload, SEED, 0.5, False, time.perf_counter(), device="cpu", size=size,
                  out=out, **kw)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_cpu_run(workload):
    line = _run(workload)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["metrics"] == {}, "a CPU run reports no device metric"
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checks"] and all(v["limit"] is not None for v in line["checks"].values())
    assert line["correct"] is True, line["checks"]


def _frames_altered(monkeypatch):
    """An answer altered where it is produced: every frame 5 counts off."""
    from ray_tracer_tpu_torch.render import renderer
    real = renderer.render
    monkeypatch.setattr(renderer, "render", lambda prep: real(prep) + 5.0)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: Adam never moves a leaf."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from ray_tracer_tpu_torch.opt import fit
    real = fit._residual

    def half(colors, target):
        d = real(colors, target)
        n = d.shape[0] // 2
        return torch.cat([d[:n] * 2.0 ** 0.5, torch.zeros_like(d[n:])])

    monkeypatch.setattr(fit, "_residual", half)


FAULTS = [(w, f) for w in WORKLOADS for f in (
    [_frames_altered] if cells.load_cell(w).traffic["mode"] == "frames"
    else [_state_unchanged, _half_batch])]


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    line = _run(workload)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(workload):
    from raybench.control import control_numbers
    limits = cells.load_cell(workload).limits
    numbers = control_numbers(workload, SEED, "cpu", SIZE[cells.load_cell(workload).traffic["mode"]])
    assert any(v > limits[k]["limit"] for k, v in numbers.items()), numbers


LOADS = """
import sys
sys.path.insert(0, {root!r})
import raybench.control, raybench.harness.main, raybench.harness.readers
import raybench.reference.fit, raybench.reference.pathtrace, raybench.tools.freeze_work
import raybench.work.C, raybench.work.E, raybench.work.F
import ray_tracer_tpu_torch.opt.fit, ray_tracer_tpu_torch.render.renderer
from raybench.harness import cells
for w in cells.benchmark()["workloads"]:
    for m in cells.load_cell(w["name"]).per_layer + cells.load_cell(w["name"]).end_to_end:
        cells.reader(m["name"])
from raybench.harness.main import forbidden_modules
print(forbidden_modules())
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
import raybench.reference.fit, raybench.reference.pathtrace, raybench.reference.whitted
import raybench.work.C, raybench.work.E, raybench.work.F
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"ray_tracer_tpu_torch", "ray_tracer_tpu", "jax"}}))
"""


@pytest.mark.parametrize("src, want", [(LOADS, "[]"), (REFERENCE_ONLY, "[]")],
                         ids=["harness", "reference"])
def test_forbidden_modules(src, want):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", src.format(root=ROOT)], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == want


def _jax_from_a_reader(monkeypatch):
    """A metric reader, loaded after the window, that loads JAX."""
    real = cells.reader

    def reader(name):
        read = real(name)

        def loads_jax(run):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return read(run)
        return loads_jax

    monkeypatch.setattr(cells, "reader", reader)


def _jax_package_from_the_reference(monkeypatch):
    """The comparison after the window loads the JAX package."""
    from raybench.harness import checks

    def wrap(fn):
        def loads_package(*a, **kw):
            monkeypatch.setitem(sys.modules, "ray_tracer_tpu.render",
                                types.ModuleType("ray_tracer_tpu.render"))
            return fn(*a, **kw)
        return loads_package

    for name in ("frame_numbers", "fit_numbers"):
        monkeypatch.setattr(checks, name, wrap(getattr(checks, name)))


@pytest.mark.parametrize("load", [_jax_from_a_reader, _jax_package_from_the_reference],
                         ids=["reader", "reference"])
def test_jax_loaded_after_the_window_prints_no_result(monkeypatch, load):
    load(monkeypatch)
    out = io.StringIO()
    rc = run_cell(WORKLOADS[0], SEED, 0.2, False, time.perf_counter(), device="cpu",
                  size=SIZE[cells.load_cell(WORKLOADS[0]).traffic["mode"]], out=out)
    assert rc != 0 and out.getvalue() == ""


def test_top_level_names_compared_whole():
    from raybench.harness.main import forbidden_modules
    sys.modules["jaxlike_probe"] = sys.modules[__name__]
    try:
        assert "jax" not in forbidden_modules()
    finally:
        del sys.modules["jaxlike_probe"]


@pytest.mark.card
def test_card_run_prints_a_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    out = subprocess.run([sys.executable, "raybench/run.py", "--workload", WORKLOADS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["correct"] is True


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "raybench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
