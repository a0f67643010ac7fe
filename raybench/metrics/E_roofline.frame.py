"""Kernel E's share of its roofline in a wave frame: the frozen work of
the upstream's walks (work/E.py) at the card's peaks over E's device
time a frame, in %."""

from raybench.harness.readers import roofline


def read(run):
    return roofline(run, "E") if run["mode"] == "frames" else None
