"""What the metric readers (`raybench/metrics/<name>.py`) share: a run's
kernels by name, per call, and a kernel's roofline share.

A reader takes the run's record and returns its number, or None where
the run holds nothing to read (no traced window, no such kernel, no
frozen work count): the metric is then left out of the result."""

from __future__ import annotations

import re

from raybench.harness.peaks import bound_s

KERNELS = {  # the program's kernels by the name its CUDA sources give them
    "C": re.compile(r"packed_march_kernel"),
    "E": re.compile(r"whitted_wave_kernel"),
    "F": re.compile(r"gi_(primary|sample|fold)_kernel"),
    "scatter": re.compile(r"indexFunc(Large|Small)Index"),
}
NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")


def traced(run: dict):
    """The run's traced window, or None (an untraced run, or no card)."""
    return run.get("trace") if run.get("device") == "cuda" else None


def device_s_per_call(run: dict, pattern) -> "float | None":
    tr = traced(run)
    if tr is None:
        return None
    s = sum(sec for name, sec in tr.kernels if pattern.search(name))
    return s / tr.calls if s > 0 else None


def roofline(run: dict, kernel: str) -> "float | None":
    """Percent of kernel `kernel`'s device time a call that its frozen
    work would take at the card's published peaks."""
    work = run.get("work", {}).get(kernel)
    dev = device_s_per_call(run, KERNELS[kernel])
    if work is None or dev is None:
        return None
    least, _ = bound_s(work["ops"], work["bytes"], run["peaks"])
    return 100.0 * least / dev


def idle_share(run: dict) -> "float | None":
    tr = traced(run)
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
