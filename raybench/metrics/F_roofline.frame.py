"""Kernel F's share of its roofline in a path-traced frame: the frozen
work of its paths (work/F.py) at the card's peaks over the device time a
frame of F's three kernels, in %."""

from raybench.harness.readers import roofline


def read(run):
    return roofline(run, "F") if run["mode"] == "frames" else None
