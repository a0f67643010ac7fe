"""`render.renderer.prepare` on the host clock, ending in a device sync,
in s (the fit: the prepare of its start, the grid it holds fixed)."""


def read(run):
    return run["split"].get("prepare_s")
