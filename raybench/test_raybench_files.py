"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name: configurations, traffic mixes, limits, metric
readers and frozen work counts."""

import json
import os
import re

import pytest

from raybench.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.benchmark()
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["raybench"]
    assert BENCH["command"] == ["python3", "raybench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = cells.load_cell(w["name"], BENCH)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert {"mode", "size", "render", "grid", "work", "libraries"} <= set(cell.traffic)
    assert {"meshes", "materials", "camera", "light", "shading"} <= set(cell.config)
    for m in cell.config["meshes"]:
        assert os.path.exists(os.path.join(cells.ROOT, m["obj"]))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))
    for m in cell.end_to_end:
        assert callable(cells.reader(m["name"]))
    assert cell.limits, "every cell has its limits"
    counts = cells.work_counts(w["name"])
    assert set(counts) == set(cell.traffic["work"])
    for c in counts.values():
        assert c["ops"] > 0 and c["bytes"] > 0


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_are_used_and_unchanged_in_shape(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"raybench/configs/{c['name']}.json"
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert c["reduced"] == []


def test_unknown_names_refused():
    with pytest.raises(KeyError):
        cells.load_cell("no_such_cell", BENCH)
    with pytest.raises(ValueError):
        cells.reader("../metrics/frame_ms")
