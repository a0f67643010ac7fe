"""Kernel C's share of its roofline in a frame: the frozen work of the
upstream's walk (work/C.py) at the card's peaks over C's device time a
frame, in %."""

from raybench.harness.readers import roofline


def read(run):
    return roofline(run, "C") if run["mode"] == "frames" else None
