"""Kernel launches a frame in the traced window (copies and sets left
out), a count."""

from raybench.harness.readers import NOT_KERNEL, traced


def read(run):
    tr = traced(run)
    if tr is None:
        return None
    return sum(1 for name, _ in tr.kernels if not NOT_KERNEL.search(name)) / tr.calls
