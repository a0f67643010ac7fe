"""Device time a frame of every operation but kernel C: the bounce loop's
camera batch and shading epilogue, in ms."""

from raybench.harness.readers import KERNELS, traced


def read(run):
    tr = traced(run)
    if tr is None:
        return None
    s = sum(sec for name, sec in tr.kernels if not KERNELS["C"].search(name))
    return 1e3 * s / tr.calls
