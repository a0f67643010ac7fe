"""bench_torch.py's single measurement against bench.py's contract, on the
CPU at 16x16 (`--device cpu`).

* The forward render, GI and the train step each print one JSON line
  whose keys are bench.py's for that mode (read from bench.py's source,
  the dicts its three measurements print) with `device` and `card`
  beside them; the forward line's vs_baseline is its value over the C++
  oracle's Mrays/s (the oracle built by tests/conftest.py's fixture),
  GI's and the train step's 0.
* The oracle's own figure: the port's oracle_mrays runs the binary and
  reads its Mrays/s; a missing oracle that cannot be built gives 0.0.
* The mode switch: a bare call selects the rows, --scene, --size, --gi or
  --grad the single measurement, --suite on/off overrides; without a card
  the rows exit 2 and --device cpu is refused for them.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402


def _bench_py_keys() -> dict:
    """{mode: keys} of the JSON lines bench.py prints: the dict literal in
    json.dumps(...) of _bench_grad, _bench_gi and main (the forward)."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        mode = {"_bench_grad": "grad", "_bench_gi": "gi", "main": "forward"}.get(fn.name)
        for node in ast.walk(fn):
            if (mode and isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                    and isinstance(node.args[0], ast.Dict)):
                keys = {k.value for k in node.args[0].keys}
                if "error" not in keys:  # main's failed-probe line
                    out[mode] = keys
    return out


BENCH_PY = _bench_py_keys()
MODES = {"forward": [], "gi": ["--gi", "2", "--gi-depth", "1"], "grad": ["--grad"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_single_line_has_bench_py_keys(mode, oracle_bin, capsys):
    assert bench_torch.main(["--device", "cpu", "--size", "16", "--repeat", "2",
                             "--rounds", "2", *MODES[mode]]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_PY[mode] | {"device", "card"}
    assert line["device"] == "cpu" and line["card"] is None and line["size"] == 16
    assert line["value"] > 0
    if mode == "forward":
        assert line["metric"] == "mrays_per_s_spot_primary_shadow"
        assert line["oracle_mrays_per_s"] > 0
        want = line["value"] / line["oracle_mrays_per_s"]
        assert abs(line["vs_baseline"] - want) <= 1e-4 + 1e-3 * want, (line, want)
    else:
        assert line["vs_baseline"] == 0.0
    if mode == "gi":
        assert line["metric"] == "gi_mrays_per_s_spot"
        assert (line["gi_samples"], line["gi_depth"]) == (2, 1)
    if mode == "grad":
        assert line["metric"] == "train_step_mrays_per_s_spot"
        assert line["trainable"] == bench_torch.SINGLE_TRAINABLE.split(",")


@pytest.mark.parametrize("scene", ["spot", "parallel"])
def test_oracle_mrays_reads_the_oracle(scene, oracle_bin):
    assert bench_torch.oracle_mrays(16, scene) > 0


def test_oracle_failure_gives_zero(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_torch, "REPO", str(tmp_path))  # no oracle, no Makefile
    assert bench_torch.oracle_mrays(16) == 0.0


@pytest.mark.parametrize("argv,rows", [
    ([], True),
    (["--rows", "spot_1024"], True),
    (["--size", "64"], False),
    (["--scene", "parallel"], False),
    (["--gi", "4"], False),
    (["--grad"], False),
    (["--suite", "on", "--size", "64"], True),
    (["--suite", "off"], False),
])
def test_mode_switch(argv, rows):
    args = bench_torch.parse_args(argv)
    assert args.suite is rows
    assert (args.scene, args.size) == ({"--scene": "parallel"}.get(argv[0] if argv else "",
                                                                   "spot"),
                                       64 if "64" in argv else 1024)


def test_rows_need_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    bare = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert bare.returncode == 2 and "no CUDA device" in bare.stderr and not bare.stdout
    cpu = subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert cpu.returncode == 2 and "card only" in cpu.stderr and not cpu.stdout
