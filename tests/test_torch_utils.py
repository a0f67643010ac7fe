"""The port's timing and logging utilities (utils/timing.py,
utils/log.py) against the JAX package's (ray_tracer_tpu/utils): the same
names, the same report keys and the same host-0 filter; on the CPU the
timers use the host's clock, and profile_trace writes a torch.profiler
trace."""

import logging
import os

import torch

torch.set_num_threads(1)

from ray_tracer_tpu.utils import log as jax_log  # noqa: E402
from ray_tracer_tpu.utils import timing as jax_timing  # noqa: E402
from ray_tracer_tpu_torch import utils  # noqa: E402
from ray_tracer_tpu_torch.utils import log, timing  # noqa: E402


def test_timer_and_time_fn():
    t = utils.Timer()
    x = torch.ones(1000)
    for _ in range(2):
        with t.span("sum", result=x):
            x.sum()
    assert set(t.spans) == {"sum"} and t.spans["sum"] > 0.0
    calls = []
    sec = timing.time_fn(lambda: calls.append(1) or x * 2, warmup=2, iters=3)
    assert sec > 0.0 and len(calls) == 5


def test_measure_mrays_reports_the_jax_keys():
    got = utils.measure_mrays(lambda: torch.ones(10) * 2, rays_per_call=1e6, iters=3)
    want = jax_timing.measure_mrays(lambda: 2, rays_per_call=1e6, iters=3)
    assert set(got) == set(want)
    assert got["devices"] == 1 and got["mrays_per_s"] == got["mrays_per_s_per_chip"] > 0


def test_profile_trace(tmp_path):
    with timing.profile_trace(None):
        pass
    with timing.profile_trace(str(tmp_path / "trace")):
        torch.ones(100).cumsum(0)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")


def test_logger_host0_filter(monkeypatch):
    lg = utils.get_logger("ray_tracer_tpu_torch.test_utils")
    assert lg is log.get_logger("ray_tracer_tpu_torch.test_utils")  # set up once
    assert len(lg.handlers) == 1 and not lg.propagate and lg.level == logging.INFO
    flt = lg.handlers[0].filters[0]
    rec = logging.LogRecord("x", logging.INFO, __file__, 1, "m", None, None)
    assert flt.filter(rec)  # process 0 without a process group
    monkeypatch.setattr(log, "process_index", lambda: 1)
    assert not flt.filter(rec)
    rec.all_hosts = True
    assert flt.filter(rec)
    assert isinstance(jax_log._Host0Filter(), logging.Filter)
