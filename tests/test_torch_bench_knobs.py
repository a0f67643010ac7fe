"""bench.py's knob overrides in bench_torch.py, on the CPU.

* Parsers: bench.py's options (its parser taken as it starts to parse) are
  bench_torch.py's, with the same destinations, types, defaults, choices
  and actions, apart from the port's own --rows and --device.
* Configs: for argv sets across spot, parallel, GI and the train step,
  the config each measures with equals bench.py's field by field
  (dataclasses.asdict), both probes answering alike.  bench.py sets
  fused_shadow, camera_refill, whitted_wave and GI's fields after its
  prepare and the port before its own (which builds kernel E's and F's
  tables from them), so each is taken where its measurement starts:
  bench.py's at render (or make_train_step), the port's at frame_chains
  (or train_chains).  Nefertiti is left out: its two prepares take ~36 s
  on the CPU, and its knobs resolve as spot's.
* The start-up probe: a child that outlives --probe-timeout prints
  bench.py's error line (its keys, read from bench.py's source) and the
  command exits 1.
* The rows' isolation: a row whose subprocess fails or hangs becomes an
  error row and the others still print.
* On the CPU at 16x16 --whitted-wave off (the parallel scene's bounce loop)
  and --gi-wave off (the segment integrator) each print one line and
  bench.py's stderr line for the choice.
"""

import argparse
import ast
import dataclasses
import json
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch  # noqa: E402
from ray_tracer_tpu.opt import fit as jax_fit  # noqa: E402
from ray_tracer_tpu.render import metrics as jax_metrics  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.render import metrics as port_metrics  # noqa: E402
from ray_tracer_tpu_torch.tools import profiling  # noqa: E402

PORT_ONLY = {"--rows", "--device"}


class _Stop(Exception):
    pass


def _bench_py_parser(monkeypatch):
    seen = {}

    def stop(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(_Stop):
        bench.main()
    monkeypatch.undo()
    return seen["parser"]


def _port_parser(monkeypatch):
    seen = {}

    def stop(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Stop):
        bench_torch.parse_args([])
    monkeypatch.undo()
    return seen["parser"]


def _option(action):
    return (action.dest, type(action), action.type, action.default,
            tuple(action.choices) if action.choices else None)


def test_parsers_have_the_same_options(monkeypatch):
    theirs = _bench_py_parser(monkeypatch)._option_string_actions
    ours = _port_parser(monkeypatch)._option_string_actions
    assert set(ours) - set(theirs) == PORT_ONLY
    assert set(theirs) <= set(ours)
    for opt, action in theirs.items():
        assert _option(ours[opt]) == _option(action), opt


ARGVS = [
    ["--size", "16"],
    ["--size", "16", "--layout", "blocks", "--fused", "off", "--scheduler", "tiled",
     "--exact", "off"],
    ["--size", "16", "--layout", "inline", "--fused", "on", "--wave", "256", "--pump", "5",
     "--block-tris", "28", "--rm", "1.5", "--max-res", "48", "--probe-chain", "2",
     "--order", "chord", "--exact", "on"],
    ["--size", "16", "--scene", "parallel"],
    ["--size", "16", "--scene", "parallel", "--whitted-wave", "off"],
    ["--size", "16", "--scene", "parallel", "--whitted-wave", "on", "--pump", "4"],
    ["--size", "16", "--gi", "2", "--gi-depth", "1", "--gi-wave", "off"],
    ["--size", "16", "--gi", "2", "--pump", "7", "--scene", "parallel"],
    ["--size", "16", "--grad", "--scene", "parallel", "--wave", "64"],
]


def _jax_config(argv, monkeypatch):
    """The config bench.py measures with, its probes answering True."""
    seen = {}

    def at_render(prep):
        seen["cfg"] = prep.cfg
        raise _Stop

    def at_step(meta, cfg, **kw):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(sys, "argv", ["bench.py", *argv, "--probe-timeout", "0"])
    monkeypatch.setattr(jax_metrics, "choose_fused_shadow", lambda prep: True)
    monkeypatch.setattr(jax_metrics, "choose_camera_refill", lambda prep: True)
    monkeypatch.setattr(jax_renderer, "render", at_render)
    monkeypatch.setattr(jax_fit, "make_train_step", at_step)
    with pytest.raises(_Stop):
        bench.main()
    monkeypatch.undo()
    return seen["cfg"]


def _port_config(argv, monkeypatch):
    """The config bench_torch.py's single measurement measures with, its
    probes answering True."""
    seen = {}

    def at_chains(prep, *a, **kw):
        seen["cfg"] = prep.cfg
        raise _Stop

    monkeypatch.setattr(port_metrics, "choose_fused_shadow", lambda prep: True)
    monkeypatch.setattr(port_metrics, "choose_camera_refill", lambda prep: True)
    monkeypatch.setattr(bench_torch, "frame_chains", at_chains)
    monkeypatch.setattr(bench_torch, "train_chains", at_chains)
    with pytest.raises(_Stop):
        bench_torch.single(bench_torch.parse_args([*argv, "--device", "cpu"]))
    monkeypatch.undo()
    return seen["cfg"]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a[2:]) or "spot" for a in ARGVS])
def test_config_is_bench_py_config(argv, monkeypatch):
    want = dataclasses.asdict(_jax_config(argv, monkeypatch))
    got = dataclasses.asdict(_port_config(argv, monkeypatch))
    assert got == want


def test_rows_are_bench_py_suite_rows():
    """Each of bench.py's SUITE rows (whose argv pins no knob) is the row of
    that name: the single measurement's config for the row's argv."""
    for row in bench.SUITE:
        args = bench_torch.parse_args(row["args"])
        want = bench_torch.scene_config(args.scene, args.size, args.gi, args.gi_depth,
                                        knobs=bench_torch.knobs_of(args))
        assert bench_torch.row_config(row["workload"]) == want, row["workload"]


def _bench_py_error_keys() -> set:
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {getattr(k, "value", None) for k in node.keys}
            if "error" in keys and "metric" in keys:
                return keys
    raise AssertionError("bench.py prints no error line")


def test_probe_timeout_prints_bench_py_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_torch, "PROBE_SRC", "import time\ntime.sleep(30)\n")
    assert bench_torch.main(["--size", "16", "--probe-timeout", "1"]) == 1
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == _bench_py_error_keys()
    assert line["value"] == 0.0 and "TimeoutExpired after 1s" in line["error"]
    assert "device backend probe failed: TimeoutExpired" in err


def test_a_failing_row_is_an_error_row(monkeypatch, capsys):
    """Three rows: one prints its line, one exits 3 with none, one hangs
    past --suite-timeout."""
    child = ("import sys, json, time\n"
             "w = sys.argv[1]\n"
             "if w == 'spot_1024':\n"
             "    print(json.dumps({'workload': w, 'value': 1.5}))\n"
             "elif w == 'parallel_1024':\n"
             "    sys.exit(3)\n"
             "else:\n"
             "    time.sleep(30)\n")
    monkeypatch.setattr(bench_torch, "ROW_CHILD", child)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(profiling, "card_line", lambda: "card, 700 W")
    args = bench_torch.parse_args(["--rows", "spot_1024,parallel_1024,gi_spot_1024_s4d2",
                                   "--suite-timeout", "3"])
    bench_torch.run_suite(args)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 4
    assert lines[0] == {"workload": "spot_1024", "value": 1.5}
    assert lines[1]["workload"] == "parallel_1024" and "error" in lines[1]
    assert lines[2]["workload"] == "gi_spot_1024_s4d2"
    assert lines[2]["error"].startswith("TimeoutExpired")
    assert lines[3]["rows"] == lines[:3]
    assert set(lines[3]) == {"rows", "card", "device", "count", "torch", "cuda"}


@pytest.mark.parametrize("argv,said", [
    (["--scene", "parallel", "--whitted-wave", "off"], "whitted_wave: off -> bounce loop"),
    (["--gi", "2", "--gi-depth", "1", "--gi-wave", "off"], "gi_wave: off -> segments"),
], ids=["whitted_wave_off", "gi_wave_off"])
def test_cpu_line_with_a_wave_off(argv, said, oracle_bin, capsys):
    assert bench_torch.main(["--device", "cpu", "--size", "16", "--repeat", "2",
                             "--rounds", "1", *argv]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["value"] > 0
    assert said in err
