"""Stress driver for the rank groups' teardown: many gloo groups of CPU
ranks through `torch_ranks.run_ranks`, each running the collectives work
of tests/test_torch_collectives.py, several groups at once.  It counts
each group's exit by world, by the rank that failed first, by its exit
code and by the minute since the start, so that an abort at interpreter
exit ("terminate called without an active exception", exit code -6) can
be counted on one tree against another under the same load.

At four groups of four ranks at once on torch's default threads (the load
below) a tree whose ranks exit with a gloo group's worker threads still
running aborted in 6 of 900 groups (on one thread a rank, 4 of 900): such
a thread that drops the last reference to a finished collective's tensor
needs the interpreter lock, which CPython refuses during finalization by
ending the thread (pthread_exit), and the unwind through
ProcessGroupGloo::runLoop ends in std::terminate.

Not a tier-1 test (marked slow: hundreds of groups take minutes):

    python tests/test_torch_teardown_stress.py --groups 300 --at-once 4 --worlds 4 --threads 0
    python -m pytest tests/test_torch_teardown_stress.py -m slow -q

The script prints one JSON summary line and exits 1 if any group failed.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_ranks import run_ranks  # noqa: E402

_FAILED = re.compile(r"rank (\d+) of \S+ on (\d+) ranks failed \(exit code (-?\d+), "
                     r"([0-9.]+) s after the start\)")


def _group(world: int, tmp: str, t0: float, threads: int) -> dict:
    start = time.monotonic()
    os.makedirs(tmp)
    try:
        run_ranks("collectives", world, tmp, threads=threads)
        return {"world": world, "ok": True, "at_s": start - t0}
    except AssertionError as err:
        m = _FAILED.search(str(err))
        fail = ({"rank": int(m.group(1)), "rc": int(m.group(3)),
                 "secs_in_group": float(m.group(4))} if m else
                {"rank": None, "rc": None, "secs_in_group": time.monotonic() - start})
        return {"world": world, "ok": False, "at_s": start - t0, **fail,
                "aborted_at_exit": "terminate called" in str(err),
                "tail": str(err)[-600:]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def stress(groups: int, at_once: int, worlds=(2, 4), threads: int = 1) -> dict:
    """Run `groups` groups (worlds taken in turn), `at_once` at a time, each
    rank on `threads` torch threads (0: torch's default) -> counts of what
    ended how."""
    root = tempfile.mkdtemp(prefix="rank_stress_")
    t0 = time.monotonic()
    try:
        with ThreadPoolExecutor(at_once) as pool:
            futs = [pool.submit(_group, worlds[i % len(worlds)],
                                os.path.join(root, f"g{i}"), t0, threads) for i in range(groups)]
            runs = [f.result() for f in futs]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failed = [r for r in runs if not r["ok"]]
    by = lambda key: dict(collections.Counter(str(key(r)) for r in failed))  # noqa: E731
    return {
        "groups": groups, "at_once": at_once, "worlds": list(worlds), "threads": threads,
        "seconds": time.monotonic() - t0,
        "groups_by_world": dict(collections.Counter(str(r["world"]) for r in runs)),
        "failed": len(failed),
        "aborted_at_exit": sum(r["aborted_at_exit"] for r in failed),
        "failed_by_world_rank": by(lambda r: f"{r['world']}:{r['rank']}"),
        "failed_by_rc": by(lambda r: r["rc"]),
        "failed_by_minute": by(lambda r: int(r["at_s"] // 60)),
        "failures": [{k: r[k] for k in ("world", "rank", "rc", "secs_in_group", "at_s")}
                     for r in failed],
        "first_tail": failed[0]["tail"] if failed else None,
    }


@pytest.mark.slow
def test_no_group_fails_under_load():
    """300 groups of four ranks on torch's default threads, four at once (a
    tree that leaves gloo threads running at exit aborted in about two of
    them): every rank of every group exits 0."""
    summary = stress(300, 4, worlds=(4,), threads=0)
    assert summary["failed"] == 0, json.dumps(summary, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=300)
    ap.add_argument("--at-once", type=int, default=4)
    ap.add_argument("--worlds", default="2,4", help="group sizes, taken in turn")
    ap.add_argument("--threads", type=int, default=1, help="a rank's torch threads, 0: torch's default")
    args = ap.parse_args(argv)
    summary = stress(args.groups, args.at_once, tuple(int(w) for w in args.worlds.split(",")),
                     args.threads)
    print(json.dumps(summary), flush=True)
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
