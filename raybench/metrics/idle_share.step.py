"""The device's idle share of the traced window of train steps: 1 - busy
/ the window's wall time, in %."""

from raybench.harness.readers import idle_share


def read(run):
    return idle_share(run) if run["mode"] == "fit" else None
