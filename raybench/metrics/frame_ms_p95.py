"""The 95th percentile of the window's frame times, each from the call of
render to its image complete on the card (host clock), in ms."""

import statistics


def read(run):
    if run["mode"] != "frames" or run["trace"] is not None or run["calls"] < 20:
        return None
    return 1e3 * statistics.quantiles(run["times"], n=20)[18]
