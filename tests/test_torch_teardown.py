"""multihost.shutdown(), the one teardown of every rank group of the port
(tests/torch_ranks.py, cli --devices, chip_smoke.py): the counterpart of
jax.distributed.shutdown.

* In a one-rank gloo group of this process, with meshes kept: after
  shutdown() no group is initialized and no thread the group started runs
  (a DeviceMesh holds its groups, whose gloo threads outlive
  destroy_process_group until the meshes go).
* A 2-rank group through run_ranks: each rank sums over its meshes'
  groups, leaves through shutdown() with no gloo thread left, and exits 0.
* A rank that raises inside the work still fails run_ranks, which names it:
  nothing in the teardown masks a failure.  It leaves at once, also while
  its peer waits in a collective it will never join (shutdown() skips its
  barrier on the way out of a failure), so the group fails well inside
  its timeout.
"""

import os
import re
import threading
import time

import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from torch_ranks import GROUP_TIMEOUT, gloo_threads, run_ranks  # noqa: E402


def test_shutdown_joins_a_one_rank_groups_threads():
    from ray_tracer_tpu_torch.parallel import multihost
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    tids = set(os.listdir("/proc/self/task"))
    python_threads = set(threading.enumerate())
    multihost.initialize(backend="gloo", timeout=60)
    make_mesh(devices="cpu")
    make_mesh(1, ("rays", "tris"), shape=(1, 1), devices="cpu")
    x = torch.ones((3,))
    dist.all_reduce(x)
    deadline = time.monotonic() + 5.0
    started = gloo_threads(since=tids)
    while len(started) < 2 and time.monotonic() < deadline:  # named as they start
        time.sleep(0.01)
        started = gloo_threads(since=tids)
    assert started, "the group started no gloo thread"
    multihost.shutdown()
    assert not dist.is_initialized()
    alive = set(os.listdir("/proc/self/task"))
    assert not alive & set(started), (started, gloo_threads(since=tids))
    assert [t for t in threading.enumerate()
            if t not in python_threads and not t.daemon] == []
    multihost.shutdown()  # without a group: nothing to do


def test_every_rank_leaves_through_shutdown(tmp_path):
    results = run_ranks("teardown", 2, tmp_path)
    for rank, res in enumerate(results):
        assert res["sums"] == [3.0, 3.0, rank + 1.0]  # world, "tris" of 2, "rays" of 1
        assert res["subgroups"] >= 1
        assert res["threads_before"], "the group started no gloo thread"
        assert res["initialized_after"] is False
        assert res["threads_after"] == {}


def test_a_failing_rank_still_fails_the_group(tmp_path):
    with pytest.raises(AssertionError, match=r"rank 1 of fail_on_rank1 on 2 ranks failed "
                                             r"\(exit code 1,") as err:
        run_ranks("fail_on_rank1", 2, tmp_path)
    assert "rank 1 fails on purpose" in str(err.value)


def test_a_rank_failing_under_a_waiting_peer_leaves_at_once(tmp_path):
    with pytest.raises(AssertionError, match=r"rank 1 of fail_in_allreduce on 2 ranks failed "
                                             r"\(exit code 1, ([0-9.]+) s after") as err:
        run_ranks("fail_in_allreduce", 2, tmp_path)
    assert "rank 1 fails on purpose" in str(err.value)
    secs = float(re.search(r"exit code 1, ([0-9.]+) s after", str(err.value)).group(1))
    assert secs < GROUP_TIMEOUT / 4, secs  # not held in a barrier to the timeout
