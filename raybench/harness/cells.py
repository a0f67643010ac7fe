"""A cell's files, found by name: its entry in `BENCHMARK.json`, its
configuration (`configs/<name>.json`), its traffic mix
(`traffic/<name>.json`), its limits (`limits/<workload>.json`) and the
readers of the metrics it reports (`metrics/<name>.py`)."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    workload: dict  # the BENCHMARK.json entry
    config: dict
    traffic: dict
    limits: dict  # number name -> {"limit", ...}
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as fh:
        return json.load(fh)


def _named(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def reports(metric: dict, workload: str) -> bool:
    """Does a cell report this metric: listed in its `workloads`, or the
    metric lists none (then every cell reports it)."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: dict = None) -> Cell:
    """The cell named `workload` with every file it names."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = _json("configs", _named(entry["config"]) + ".json")
    traffic = _json("traffic", _named(entry["traffic"]) + ".json")
    path = os.path.join(BENCH_DIR, "limits", _named(workload) + ".json")
    limits = {}
    if os.path.exists(path):
        with open(path) as fh:
            limits = json.load(fh)
    return Cell(entry, cfg, traffic, limits,
                [m for m in bench["end_to_end"] if reports(m, workload)],
                [m for m in bench["per_layer"] if reports(m, workload)])


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", _named(metric) + ".py")
    spec = importlib.util.spec_from_file_location(f"raybench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def work_counts(workload: str) -> dict:
    """The frozen work counts of a cell (`work/counts/<workload>.json`),
    {} where none were frozen."""
    path = os.path.join(BENCH_DIR, "work", "counts", _named(workload) + ".json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)
