"""Kernel C's share of its roofline in a train step's forward: the frozen
work of the upstream's walk (work/C.py) at the card's peaks over C's
device time a step, in %."""

from raybench.harness.readers import roofline


def read(run):
    return roofline(run, "C") if run["mode"] == "fit" else None
