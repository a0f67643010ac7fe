"""Frame time: the measured window's seconds over the frames completed in
it, closed loop (host clock), in ms."""


def read(run):
    if run["mode"] != "frames" or run["trace"] is not None:
        return None
    return 1e3 * run["window_s"] / run["calls"]
